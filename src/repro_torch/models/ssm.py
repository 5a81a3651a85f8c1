# Port of repro/models/ssm.py: the SSD core and the full-sequence Mamba-2
# block.
"""Mamba-2 (SSD — state-space duality) blocks.

The SSD recurrence per head (state N, head dim P)::

    h_t = a_t * h_{t-1} + dt_t * B_t  (outer) x_t         h: (P, N)
    y_t = h_t @ C_t + D * x_t                             a_t = exp(dt_t * A)

:func:`ssd_chunked` evaluates it with the chunked algorithm of the Mamba-2
paper.  On the card its forward is the SSD-scan kernel
(:mod:`repro_torch.kernels.ssd_scan`); its backward recomputes the plain
chunked form (:func:`ssd_chunked_plain`) under autograd and backpropagates
through it, as the JAX package differentiates its XLA path (it has no SSD
backward kernel).  On the CPU the plain form runs under autograd directly.
:func:`ssd_sequential` is the O(T) oracle of the tests.  The single-token
decode step comes with decode (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models.layers import (DEFAULT_DTYPES, DTypes, dense,
                                       init_dense, normal, zeros)

Params = Any


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_sequential(x, dt, A, B, C, h0=None):
    """Oracle recurrence.  x: (b,t,h,p); dt: (b,t,h); A: (h,); B, C:
    (b,t,g,n), heads mapped to groups in H // G contiguous blocks.  Returns
    (y (b,t,h,p) fp32, h_final (b,h,p,n))."""
    b, t, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).float()  # (b,t,H,n)
    Ch = C.repeat_interleave(rep, dim=2).float()
    a = torch.exp(dt * A[None, None, :])  # (b,t,H)
    xf = x.float()
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    ys = []
    for s in range(t):
        upd = torch.einsum("bhp,bhn->bhpn", xf[:, s] * dt[:, s, :, None],
                           Bh[:, s])
        h = h * a[:, s, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, s]))
    return torch.stack(ys, dim=1), h


def ssd_chunked_plain(x, dt, A, B, C, *, chunk: int = 64, h0=None):
    """Chunked SSD (Mamba-2 alg.) in plain PyTorch.  Same contract as
    :func:`ssd_sequential`, y in x's dtype."""
    b, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    if T % chunk != 0:
        chunk = T
    nc = T // chunk

    xf = x.float().reshape(b, nc, chunk, H, P)
    dtf = dt.float().reshape(b, nc, chunk, H)
    Bf = B.float().reshape(b, nc, chunk, G, N)
    Cf = C.float().reshape(b, nc, chunk, G, N)
    la = dtf * A[None, None, None, :]          # log a  (b,c,l,h)
    ca = torch.cumsum(la, dim=2)               # cumulative within chunk
    xbar = xf * dtf[..., None]                 # dt-weighted input

    # ---- intra-chunk (dual / attention-like form) --------------------------
    Bh = Bf.repeat_interleave(rep, dim=3)      # (b,c,l,H,n)
    Ch = Cf.repeat_interleave(rep, dim=3)
    cb = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    seg = ca[..., :, None, :] - ca[..., None, :, :]        # (b,c,l,s,h)
    li = torch.arange(chunk, device=x.device)
    causal = li[:, None] >= li[None, :]
    # mask BEFORE exp: exp of masked (positive) entries overflows and the
    # where-backward would give 0 * inf = NaN gradients otherwise
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.full((), float("-inf"), device=x.device))
    decay = torch.exp(seg)
    M = cb * decay.permute(0, 1, 4, 2, 3)                  # (b,c,h,l,s)
    y_intra = torch.einsum("bchls,bcshp->bclhp", M, xbar)

    # ---- chunk states -------------------------------------------------------
    last = ca[:, :, -1:, :]                                 # (b,c,1,h)
    dec_to_end = torch.exp(last - ca)                       # (b,c,l,h)
    S_c = torch.einsum("bclhn,bclhp->bchpn", Bh * dec_to_end[..., None],
                       xbar)

    # ---- inter-chunk scan ---------------------------------------------------
    chunk_decay = torch.exp(last[:, :, 0, :])               # (b,c,h)
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    h_before = []
    for c in range(nc):
        h_before.append(h)  # the state *entering* the chunk
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_before = torch.stack(h_before, dim=1)                 # (b,c,h,p,n)

    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           Ch * torch.exp(ca)[..., None], h_before)
    y = (y_intra + y_inter).reshape(b, T, H, P)
    return y.to(x.dtype), h


class SSDScan(torch.autograd.Function):
    """The chunked SSD with the kernel's forward (CUDA tensors) and the
    plain chunked form's backward (recomputed under autograd)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk):
        f32 = torch.float32
        y, hf = ssd_kernel.ssd_scan(
            x.contiguous(), dt.to(f32).contiguous(), A.to(f32).contiguous(),
            B.contiguous(), C.contiguous(), chunk=chunk,
            h0=None if h0 is None else h0.to(f32).contiguous())
        ctx.save_for_backward(x, dt, A, B, C, h0)
        ctx.chunk = chunk
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, needs)]
            y, hf = ssd_chunked_plain(*ins[:5], chunk=ctx.chunk, h0=ins[5])
            wanted = [t for t in ins if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad((y, hf), wanted, (dy, dhf),
                                             allow_unused=True)
                         if wanted else [])
        out = [next(grads) if t is not None and t.requires_grad else None
               for t in ins]
        return (*out, None)


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 64, h0=None):
    """Chunked SSD.  x: (b,t,h,p); dt: (b,t,h); A: (h,); B, C: (b,t,g,n);
    optional entry state h0 (b,h,p,n).  Returns (y (b,t,h,p) in x's dtype,
    h_final (b,h,p,n) fp32).  The SSD-scan kernel on the card, the plain
    chunked form on the CPU."""
    if x.is_cuda:
        return SSDScan.apply(x, dt, A, B, C, h0, chunk)
    return ssd_chunked_plain(x, dt, A, B, C, chunk=chunk, h0=h0)


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def init_mamba2(generator, d_model: int, *, d_state: int = 128,
                headdim: int = 64, expand: int = 2, ngroups: int = 1,
                conv_k: int = 4, dtype=torch.float32,
                lead: Tuple[int, ...] = (), device=None) -> Params:
    """``lead``: leading stacked axes (the period axis of ``init_lm``)."""
    d_inner = expand * d_model
    nheads = d_inner // headdim
    conv_dim = d_inner + 2 * ngroups * d_state
    d_proj = 2 * d_inner + 2 * ngroups * d_state + nheads
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, dtype=dtype))
    return {
        "in_proj": init_dense(generator, d_model, d_proj, dtype=dtype,
                              lead=lead, device=device),
        "conv_w": normal(generator, (*lead, conv_k, conv_dim), 0.2,
                         device=device, dtype=dtype),
        "conv_b": zeros((*lead, conv_dim), device=device, dtype=dtype),
        "A_log": a_log.expand(*lead, nheads).contiguous().to(device),
        "D": torch.ones((*lead, nheads), device=device, dtype=dtype),
        "dt_bias": zeros((*lead, nheads), device=device, dtype=dtype),
        "norm_scale": zeros((*lead, d_inner), device=device, dtype=dtype),
        "out_proj": init_dense(generator, d_inner, d_model, dtype=dtype,
                               lead=lead, device=device),
    }


def _split_proj(z, d_inner, ngroups, d_state, nheads):
    zs = [d_inner, d_inner, ngroups * d_state, ngroups * d_state, nheads]
    idx = [0]
    for s in zs:
        idx.append(idx[-1] + s)
    return tuple(z[..., idx[i]:idx[i + 1]] for i in range(5))


def _gated_norm(p, y, z, eps=1e-6):
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * (1.0 + p["norm_scale"].float())


def mamba2_block(p: Params, x: torch.Tensor, *, d_state: int = 128,
                 headdim: int = 64, expand: int = 2, ngroups: int = 1,
                 conv_k: int = 4, chunk: int = 64,
                 dt: DTypes = DEFAULT_DTYPES, state=None,
                 return_state: bool = False):
    """Full-sequence (training) Mamba-2 mixer.  x: (B, T, d).

    ``state`` / ``return_state``: optional (conv_state (B, K-1, conv_dim),
    ssm_state (B, H, P, N)) carried between sequence pieces."""
    Bsz, T, d_model = x.shape
    d_inner = expand * d_model
    nheads = d_inner // headdim
    zxbcdt = dense(p["in_proj"], x, dt)
    z, xi, Bc, Cc, dt_raw = _split_proj(zxbcdt, d_inner, ngroups, d_state,
                                        nheads)

    # causal depthwise conv over (x, B, C); prev conv window via `state`
    xbc = torch.cat([xi, Bc, Cc], dim=-1)
    conv_state_in = (state[0] if state is not None else
                     torch.zeros((Bsz, conv_k - 1, xbc.shape[-1]),
                                 dtype=xbc.dtype, device=x.device))
    pad = torch.cat([conv_state_in.to(xbc.dtype), xbc], dim=1)
    conv = sum(pad[:, i:i + T, :] * dt.c(p["conv_w"][i])[None, None, :]
               for i in range(conv_k)) + dt.c(p["conv_b"])
    conv = F.silu(conv)
    new_conv_state = pad[:, T:, :]
    xi = conv[..., :d_inner]
    Bc = conv[..., d_inner:d_inner + ngroups * d_state]
    Cc = conv[..., d_inner + ngroups * d_state:]

    dts = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(Bsz, T, nheads, headdim)
    Bg = Bc.reshape(Bsz, T, ngroups, d_state)
    Cg = Cc.reshape(Bsz, T, ngroups, d_state)
    h0 = state[1].float() if state is not None else None
    y, hf = ssd_chunked(xh, dts, A, Bg, Cg, chunk=chunk, h0=h0)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bsz, T, d_inner)
    y = _gated_norm(p, y, z).to(dt.compute)
    out = dense(p["out_proj"], y, dt)
    if return_state:
        return out, (new_conv_state.float(), hf)
    return out
