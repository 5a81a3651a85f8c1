# Port of repro/kernels/ref.py: the oracles of every kernel.
"""Plain PyTorch oracles for the hand-written kernels."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Sk, D) — heads already flattened/repeated.
    Scores in fp32 (bf16 inputs are exact in fp32)."""
    D = q.shape[-1]
    sc = (D ** -0.5) if scale is None else scale
    s = torch.einsum("bsd,btd->bst", (q * sc).float(), k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    Sq, Sk = q.shape[1], k.shape[1]
    qp = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kp = torch.arange(Sk, device=q.device)
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kp[None, :] <= qp[:, None]
    if window is not None:
        m &= qp[:, None] - kp[None, :] < window
    s = torch.where(m[None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bst,btd->bsd", p.float(), v.float()).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, dt: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """Sequential SSD oracle, heads flattened.

    x: (BH, T, P) inputs; la: (BH, T) log-decay (dt * A, negative);
    b, c: (BH, T, N); dt: (BH, T) step sizes; ``h0``: optional (BH, P, N)
    entry state (zeros in the JAX package's oracle).
    Returns (y (BH, T, P), h_final (BH, P, N))::

        h_t = exp(la_t) * h_{t-1} + (dt_t * x_t) outer b_t
        y_t = h_t @ c_t
    """
    BH, T, P = x.shape
    N = b.shape[-1]
    f32 = torch.float32
    xf, laf, bf, cf, dtf = (t.to(f32) for t in (x, la, b, c, dt))
    h = torch.zeros((BH, P, N), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    ys = []
    for t in range(T):
        h = h * torch.exp(laf[:, t])[:, None, None] + torch.einsum(
            "bp,bn->bpn", xf[:, t] * dtf[:, t, None], bf[:, t])
        ys.append(torch.einsum("bpn,bn->bp", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h


def lstm_cell_ref(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor):
    """x: (B, Dx); h, c: (B, Dh); w: (Dx+Dh, 4Dh); b: (4Dh,)."""
    z = torch.cat([x, h], dim=-1) @ w + b
    i, f, o, g = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new
