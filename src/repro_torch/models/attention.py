# Port of repro/models/attention.py: the training path (chunked attention
# with its flash-style backward, the dense oracle, the attention block and
# the encoder-decoder's cross attention).
"""GQA attention: the memory-efficient chunked (flash-style) training path
with a hand-written backward, and the dense oracle.

:class:`ChunkedAttention` is a ``torch.autograd.Function``.  Its forward is
the flash-attention kernel on the card (:mod:`repro_torch.kernels.
flash_attention`, which also writes the logsumexp) and the plain online-
softmax scan :func:`_chunked_fwd` on the CPU; either way it saves
``(q, k, v, out, lse)``.  Its backward recomputes the probabilities from
the saved logsumexp, so the ``(Sq, Sk)`` score matrix never exists: on the
card the hand-written backward kernel ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``), on the CPU its plain version
:func:`_chunked_bwd`, chunk by chunk.  The JAX package has no attention
backward kernel of its own: its custom VJP's backward runs inside the
segment kernel the decoder body is traced into
(``repro/kernels/segment_pallas.py``), and this is the port of that
arithmetic.

Supports grouped KV heads, causal masking with queries at the end of the
keys, sliding windows (Gemma-2 local layers), logit softcapping and QKV
bias.  ``distributed.sharding.constrain`` is the identity on one device and
is dropped.  The KV cache and ``decode_attention`` come with decode
(ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import build
from repro_torch.models.layers import (DEFAULT_DTYPES, DTypes, apply_rope_qk,
                                       dense, init_dense)

Params = Any
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked attention with a flash-style backward
# ---------------------------------------------------------------------------


def _mask_chunk(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk_chunk) boolean validity mask."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _scores(q, kc, cap):
    # q: (B,G,Hg,Sq,D) kc: (B,G,C,D) -> (B,G,Hg,Sq,C), fp32
    s = torch.einsum("bghsd,bgcd->bghsc", q.float(), kc.float())
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    return s


def _layout(q, k, v, scale):
    B, Sq, H, D = q.shape
    G = k.shape[2]
    Hg = H // G
    scale = (D ** -0.5) if scale is None else scale
    qt = (q * scale).permute(0, 2, 1, 3).reshape(B, G, Hg, Sq, D)
    kt = k.permute(0, 2, 1, 3)  # (B, G, Sk, D)
    vt = v.permute(0, 2, 1, 3)
    return qt, kt, vt, (B, Sq, H, D, G, Hg)


def _chunks(Sk: int, chunk: int) -> Tuple[int, int]:
    if Sk % chunk != 0:
        chunk = Sk
    return chunk, Sk // chunk


def _chunked_fwd(q, k, v, causal, window, softcap, chunk, scale):
    """Online-softmax scan over KV chunks.  Returns ``(out, lse)``: out
    ``(B, Sq, H, D)`` in q's dtype, lse ``(B, G, Hg, Sq)`` fp32."""
    qt, kt, vt, (B, Sq, H, D, G, Hg) = _layout(q, k, v, scale)
    Sk = kt.shape[2]
    chunk, n_chunks = _chunks(Sk, chunk)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev) + (Sk - Sq)  # queries end the keys
    acc = torch.zeros((B, G, Hg, Sq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, G, Hg, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, G, Hg, Sq), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    for j in range(n_chunks):
        kj = kt[:, :, j * chunk:(j + 1) * chunk]
        vj = vt[:, :, j * chunk:(j + 1) * chunk]
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        s = _scores(qt, kj, softcap)  # (B,G,Hg,Sq,C) fp32
        mask = _mask_chunk(q_pos, k_pos, causal, window)
        s = torch.where(mask[None, None, None], s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bghsc,bgcd->bghsd", p.to(vj.dtype).float(), vj.float())
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    lse = m + torch.log(l)
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3), lse


def _chunked_bwd(causal, window, softcap, chunk, scale, res, dout):
    """Flash-style backward: probabilities recomputed per chunk from the
    saved logsumexp.  Returns ``(dq, dk, dv)``."""
    q, k, v, out, lse = res
    qt, kt, vt, (B, Sq, H, D, G, Hg) = _layout(q, k, v, scale)
    sc = (D ** -0.5) if scale is None else scale
    Sk = kt.shape[2]
    chunk, n_chunks = _chunks(Sk, chunk)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev) + (Sk - Sq)
    do = dout.permute(0, 2, 1, 3).reshape(B, G, Hg, Sq, D)
    ot = out.permute(0, 2, 1, 3).reshape(B, G, Hg, Sq, D)
    Dv = torch.sum(do.float() * ot.float(), dim=-1)
    neg = torch.full((), NEG_INF, device=dev)
    qf, dof = qt.float(), do.float()
    dq = torch.zeros((B, G, Hg, Sq, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(n_chunks):
        kj = kt[:, :, j * chunk:(j + 1) * chunk]
        vj = vt[:, :, j * chunk:(j + 1) * chunk]
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        s_raw = torch.einsum("bghsd,bgcd->bghsc", qf, kj.float())
        if softcap is not None:
            t = torch.tanh(s_raw / softcap)
            s = softcap * t
            dcap = 1.0 - t * t
        else:
            s, dcap = s_raw, None
        mask = _mask_chunk(q_pos, k_pos, causal, window)
        s = torch.where(mask[None, None, None], s, neg)
        p = torch.exp(s - lse[..., None])  # (B,G,Hg,Sq,C)
        dvs.append(torch.einsum("bghsc,bghsd->bgcd",
                                p.to(do.dtype).float(), dof))
        dp = torch.einsum("bghsd,bgcd->bghsc", dof, vj.float())
        ds = p * (dp - Dv[..., None])
        if dcap is not None:
            ds = ds * dcap
        ds = torch.where(mask[None, None, None], ds,
                         torch.zeros((), device=dev))
        dq = dq + torch.einsum("bghsc,bgcd->bghsd",
                               ds.to(kj.dtype).float(), kj.float())
        dks.append(torch.einsum("bghsc,bghsd->bgcd",
                                ds.to(qt.dtype).float(), qf))
    dq = (dq * sc).reshape(B, H, Sq, D).permute(0, 2, 1, 3).to(q.dtype)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3).to(k.dtype)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


class ChunkedAttention(torch.autograd.Function):
    """q: (B, Sq, H, D); k, v: (B, Sk, G, D) with H % G == 0 ->
    (B, Sq, H, D).  Never materialises (Sq, Sk)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, chunk, scale):
        if build.on_card(q):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window, softcap=softcap,
                scale=scale)
        else:
            out, lse = _chunked_fwd(q, k, v, causal, window, softcap, chunk,
                                    scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if build.on_card(q):
            causal, window, softcap, _, scale = ctx.args
            dq, dk, dv = fa.flash_attention_bwd(
                q, k, v, out.contiguous(), lse, dout.contiguous(),
                causal=causal, window=window, softcap=softcap, scale=scale)
        else:
            dq, dk, dv = _chunked_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None, chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, G, D) with H % G == 0.
    Returns (B, Sq, H, D).  Never materialises (Sq, Sk)."""
    return ChunkedAttention.apply(q, k, v, causal, window, softcap, chunk,
                                  scale)


def reference_attention(q, k, v, causal=True, window=None, softcap=None,
                        scale=None) -> torch.Tensor:
    """Naive O(S^2)-memory oracle used by tests and tiny smoke shapes."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    Hg = H // G
    sc = (D ** -0.5) if scale is None else scale
    qt = (q * sc).permute(0, 2, 1, 3).reshape(B, G, Hg, Sq, D)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    s = torch.einsum("bghsd,bgtd->bghst", qt.float(), kt.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)
    mask = _mask_chunk(q_pos, k_pos, causal, window)
    s = torch.where(mask[None, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bghst,bgtd->bghsd", p, vt)
    return o.reshape(B, H, Sq, D).permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (projections + rope)
# ---------------------------------------------------------------------------


def init_attention(generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False,
                   dtype=torch.float32, lead: Tuple[int, ...] = (),
                   device=None) -> Params:
    def dn(d_in, d_out, bias):
        return init_dense(generator, d_in, d_out, bias=bias, dtype=dtype,
                          lead=lead, device=device)

    return {
        "wq": dn(d_model, n_heads * head_dim, qkv_bias),
        "wk": dn(d_model, n_kv_heads * head_dim, qkv_bias),
        "wv": dn(d_model, n_kv_heads * head_dim, qkv_bias),
        "wo": dn(n_heads * head_dim, d_model, False),
    }


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim, dt):
    B, S, _ = x.shape
    q = dense(p["wq"], x, dt).reshape(B, S, n_heads, head_dim)
    k = dense(p["wk"], x, dt).reshape(B, S, n_kv_heads, head_dim)
    v = dense(p["wv"], x, dt).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def attention(p: Params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              head_dim: int,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              chunk: int = 1024, use_chunked: Optional[bool] = None,
              dt: DTypes = DEFAULT_DTYPES) -> torch.Tensor:
    """Self-attention over a full sequence (training compute).  Sequences
    longer than 2048 take the chunked path (the flash kernel on the card),
    shorter ones the dense oracle, as in the JAX package."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim, dt)
    if rope is not None:
        q, k = apply_rope_qk(q, k, *rope)
    S = x.shape[1]
    if use_chunked is None:
        use_chunked = S > 2048
    if use_chunked:
        o = chunked_attention(q, k, v, causal, window, softcap, chunk, scale)
    else:
        o = reference_attention(q, k, v, causal, window, softcap, scale)
    B = x.shape[0]
    return dense(p["wo"], o.reshape(B, S, n_heads * head_dim), dt)


def cross_attention(p: Params, x: torch.Tensor, kv_src: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    dt: DTypes = DEFAULT_DTYPES) -> torch.Tensor:
    """Encoder-decoder cross attention (non-causal over ``kv_src``, no
    rope), through the dense oracle as in the JAX package."""
    B, S, _ = x.shape
    Sk = kv_src.shape[1]
    q = dense(p["wq"], x, dt).reshape(B, S, n_heads, head_dim)
    k = dense(p["wk"], kv_src, dt).reshape(B, Sk, n_kv_heads, head_dim)
    v = dense(p["wv"], kv_src, dt).reshape(B, Sk, n_kv_heads, head_dim)
    o = reference_attention(q, k, v, causal=False)
    return dense(p["wo"], o.reshape(B, S, n_heads * head_dim), dt)
