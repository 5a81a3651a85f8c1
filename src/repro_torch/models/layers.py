# Port of repro/models/layers.py: the training-path building blocks.
"""Shared neural-net building blocks (plain PyTorch functions).

Conventions, as in the JAX package:

* params are nested dicts of tensors; every module is an
  ``init_*(generator, ...) -> params`` / ``*(params, x, ...)`` pair.
* parameters are stored in ``param_dtype`` (fp32) and cast to
  ``compute_dtype`` (bf16) at use — the usual mixed-precision setup.
* stacked-layer parameters carry a leading layer axis, so depth is a loop
  over that axis (the JAX package's ``lax.scan``).

``init_*`` draw from a ``torch.Generator`` on the generator's own device
(a CUDA generator draws on the card, where full-width weights are made)
and place the result on ``device``.  ``apply_rope_at`` belongs to decode
and comes with it (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Any


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DTypes:
    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16

    def c(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute)


DEFAULT_DTYPES = DTypes()


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def normal(generator: torch.Generator, shape, std: float, *, device,
           dtype=torch.float32) -> torch.Tensor:
    """``std``-scaled standard normals drawn on the generator's device,
    placed on ``device``."""
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=dtype)
    return t.mul_(std).to(device)


def zeros(shape, *, device, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def init_dense(generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, scale: Optional[float] = None,
               lead: Tuple[int, ...] = (), device=None) -> Params:
    """``lead``: leading stacked axes (the period axis of ``init_lm``)."""
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": normal(generator, (*lead, d_in, d_out), scale, device=device,
                     dtype=dtype)}
    if bias:
        p["b"] = zeros((*lead, d_out), device=device, dtype=dtype)
    return p


def dense(p: Params, x: torch.Tensor,
          dt: DTypes = DEFAULT_DTYPES) -> torch.Tensor:
    y = x @ dt.c(p["w"])
    if "b" in p:
        y = y + dt.c(p["b"])
    return y


def init_rmsnorm(d: int, dtype=torch.float32, *, lead: Tuple[int, ...] = (),
                 device=None) -> Params:
    return {"scale": zeros((*lead, d), device=device, dtype=dtype)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6,
            dt: DTypes = DEFAULT_DTYPES) -> torch.Tensor:
    # Gemma-style: normalise in fp32, weight stored as offset from 1.
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
    return y.to(dt.compute)


def init_embedding(generator, vocab: int, d: int, dtype=torch.float32, *,
                   device=None) -> Params:
    return {"emb": normal(generator, (vocab, d), d ** -0.5, device=device,
                          dtype=dtype)}


def embed(p: Params, tokens: torch.Tensor,
          dt: DTypes = DEFAULT_DTYPES) -> torch.Tensor:
    # gather, then cast: the JAX package's cast-then-gather gives the same
    # values without a compute-type copy of the whole table
    return dt.c(F.embedding(tokens.long(), p["emb"]))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.gelu(gate, approximate="tanh") * up


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_table(seq_len: int, head_dim: int, theta: float = 10000.0,
               dtype=torch.float32, *, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin) of shape (seq_len, head_dim // 2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=dtype, device=device)
                      / half)
    angles = torch.arange(seq_len, dtype=dtype,
                          device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) — rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[..., :, None, :]  # (S, 1, D/2) broadcast over heads
    sin = sin[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materialises full (B, S, V) logits)
# ---------------------------------------------------------------------------


def chunked_ce_loss(h: torch.Tensor, emb_w: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 512,
                    logit_cap: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross entropy over sequence chunks, so the full
    logits tensor (B, S, V) never exists.  ``emb_w``: (V, d) output
    embedding (possibly tied).  ``mask``: optional (B, S) validity mask.
    ``valid_vocab``: logical vocab when the table is padded — padded logits
    are masked out of the partition function.  A sequence length that does
    not divide into ``chunk`` gets a shorter remainder chunk.

    Memory: O(B * chunk * V).  Under autograd each chunk is recomputed in
    the backward (``torch.utils.checkpoint``), so its logits are not kept
    across chunks — the counterpart of XLA's scan, whose per-chunk
    residuals the JAX package leaves to the compiler.  Values are those of
    the plain loop.
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    num_full, rem = divmod(S, chunk)
    V = emb_w.shape[0]
    pad_mask = None
    if valid_vocab is not None and valid_vocab < V:
        pad_mask = torch.arange(V, device=h.device) < valid_vocab
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    wt = emb_w.to(h.dtype)

    def terms(hk, lk, mk):
        logits = hk @ wt.T  # (B, chunk, V)
        logits = softcap(logits.float(), logit_cap)
        if pad_mask is not None:
            logits = torch.where(pad_mask[None, None, :], logits,
                                 torch.full((), -1e30, device=h.device))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lk.long()[..., None])[..., 0]
        nll = (lse - gold) * mk
        return torch.sum(nll), torch.sum(mk)

    def run(hk, lk, mk):
        if torch.is_grad_enabled() and hk.requires_grad:
            return checkpoint(terms, hk, lk, mk, use_reentrant=False)
        return terms(hk, lk, mk)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(num_full):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = run(h[:, sl], labels[:, sl], mask[:, sl])
        tot, cnt = tot + t, cnt + c
    if rem:
        Sf = num_full * chunk
        t, c = run(h[:, Sf:], labels[:, Sf:], mask[:, Sf:])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_logits(h: torch.Tensor, emb_w: torch.Tensor,
              logit_cap: Optional[float] = None,
              valid_vocab: Optional[int] = None) -> torch.Tensor:
    logits = h @ emb_w.to(h.dtype).T
    logits = softcap(logits.float(), logit_cap)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits = logits[..., :valid_vocab]
    return logits
