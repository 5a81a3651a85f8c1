# Port of repro/models/ssm.py: the SSD core and the full-sequence Mamba-2
# block.
"""Mamba-2 (SSD — state-space duality) blocks.

The SSD recurrence per head (state N, head dim P)::

    h_t = a_t * h_{t-1} + dt_t * B_t  (outer) x_t         h: (P, N)
    y_t = h_t @ C_t + D * x_t                             a_t = exp(dt_t * A)

:func:`ssd_chunked` evaluates it with the chunked algorithm of the Mamba-2
paper.  On the card (``build.on_card``) its forward is the SSD-scan kernel
and its backward the SSD-scan backward kernel
(:mod:`repro_torch.kernels.ssd_scan`), which recomputes the chunks' decays
and entry states itself; elsewhere (CPU and meta tensors) the plain chunked
form :func:`ssd_chunked_plain` runs under autograd.  :func:`mamba2_block`
likewise takes the kernels of its causal conv, its step sizes and its
gated norm on the card (:mod:`repro_torch.kernels.causal_conv`,
:mod:`~repro_torch.kernels.dt_softplus`,
:mod:`~repro_torch.kernels.gated_norm`) and their plain versions, the JAX
package's operations one for one, elsewhere.  :func:`ssd_sequential` is
the O(T) oracle of the tests.  The single-token decode step comes with
decode (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import causal_conv as conv_kernel
from repro_torch.kernels import dt_softplus as dt_kernel
from repro_torch.kernels import gated_norm as gate_kernel
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
    """The chunked SSD with the kernels' forward and backward (card
    tensors; elsewhere their plain versions); only the inputs are
    saved."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk):
        f32 = torch.float32
        args = (x.contiguous(), dt.to(f32).contiguous(),
                A.to(f32).contiguous(), B.contiguous(), C.contiguous(),
                None if h0 is None else h0.to(f32).contiguous())
        y, hf = ssd_kernel.ssd_scan(*args[:5], chunk=chunk, h0=args[5])
        ctx.save_for_backward(*args)
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (x, dt, A, B, C, h0))
        ctx.chunk = chunk
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, dt, A, B, C, h0 = ctx.saved_tensors
        bwd = (ssd_kernel.ssd_scan_bwd if build.on_card(x)
               else ssd_kernel.ssd_scan_bwd_plain)
        grads = bwd(x, dt, A, B, C, h0, dy.to(x.dtype).contiguous(),
                    None if dhf is None else dhf.float().contiguous(),
                    chunk=ctx.chunk)
        return (*[g.to(dtype) if need and g is not None else None
                  for g, need, dtype in zip(grads, ctx.needs_input_grad,
                                            ctx.dtypes)], None)


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 64, h0=None):
    """Chunked SSD.  x: (b,t,h,p); dt: (b,t,h); A: (h,); B, C: (b,t,g,n);
    optional entry state h0 (b,h,p,n).  Returns (y (b,t,h,p) in x's dtype,
    h_final (b,h,p,n) fp32).  The SSD-scan kernels on the card, the plain
    chunked form elsewhere."""
    if build.on_card(x):
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


def _proj_grad_buffer(zxbcdt: torch.Tensor) -> torch.Tensor:
    """The cotangent buffer of ``zxbcdt`` that :class:`_Mixer`'s backward
    kernels fill column range by column range (uninitialised: every
    column is written once)."""
    return torch.empty_like(zxbcdt)


class _Mixer(torch.autograd.Function):
    """mamba2's mixer between its projections on the card: ``zxbcdt`` (B,
    T, d_proj) -> (the gated norm's output (B, T, d_inner), the final SSD
    state).  Forward: the conv reads the xBC columns in place and writes x,
    B and C apart, the step sizes read the dt columns in place, the SSD
    takes x, B and C as they are, the gated norm reads the z columns in
    place.  Backward: ``gated_norm_bwd`` writes dz, ``dt_softplus_bwd`` d
    dt_raw and ``causal_conv_bwd`` dxBC (its cotangent read as the SSD's
    dx, dB, dC with the gated norm's skip cotangent added to dx) into their
    columns of one uninitialised buffer.  Saves ``zxbcdt``, x, B, C, the
    step sizes, the SSD's output and the norm's ``rstd``."""

    @staticmethod
    def forward(ctx, zxbcdt, w, bias, dt_bias, A, D, scale, window, h0,
                dims):
        d_inner, ngroups, d_state, headdim, chunk, out_dtype = dims
        Bsz, T, _ = zxbcdt.shape
        gn = ngroups * d_state
        z = zxbcdt[..., :d_inner]
        xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
        dt_raw = zxbcdt[..., 2 * d_inner + 2 * gn:]
        xi, Bc, Cc = conv_kernel.causal_conv(xbc, w, bias, window,
                                             splits=(d_inner, gn, gn))
        dts = dt_kernel.dt_softplus(dt_raw, dt_bias)
        xh = xi.view(Bsz, T, d_inner // headdim, headdim)
        Bg = Bc.view(Bsz, T, ngroups, d_state)
        Cg = Cc.view(Bsz, T, ngroups, d_state)
        y, hf = ssd_kernel.ssd_scan(xh, dts, A, Bg, Cg, chunk=chunk, h0=h0)
        out, rstd = gate_kernel.gated_norm(y, xh, D, z, scale,
                                           out_dtype=out_dtype)
        ctx.save_for_backward(zxbcdt, w, bias, dt_bias, A, D, scale, window,
                              h0, xh, Bg, Cg, dts, y, rstd)
        ctx.dims = dims
        ctx.set_materialize_grads(False)
        return out, hf

    @staticmethod
    def backward(ctx, g, dhf):
        (zxbcdt, w, bias, dt_bias, A, D, scale, window, h0, xh, Bg, Cg, dts,
         y, rstd) = ctx.saved_tensors
        d_inner, ngroups, d_state, _, chunk, _ = ctx.dims
        gn = ngroups * d_state
        c0, c1 = d_inner, 2 * d_inner + 2 * gn
        if g is None:
            g = torch.zeros(y.shape[:2] + (d_inner,), dtype=ctx.dims[5],
                            device=y.device)
        g = build.cotangent(g)
        dzx = _proj_grad_buffer(zxbcdt)
        dy, dx_skip, dD, _, dscale = gate_kernel.gated_norm_bwd(
            g, y, xh, D, zxbcdt[..., :c0], scale, rstd,
            dz_out=dzx[..., :c0])
        # the final state's cotangent (B, H, P, N): fp32 as the kernel
        # takes it (None where the state is not read, as in training)
        dhf = None if dhf is None else dhf.float().contiguous()
        dx, ddt, dA, dB, dC, dh0 = ssd_kernel.ssd_scan_bwd(
            xh, dts, A, Bg, Cg, h0, dy, dhf, chunk=chunk)
        _, ddt_bias = dt_kernel.dt_softplus_bwd(
            ddt, zxbcdt[..., c1:], dt_bias, draw_out=dzx[..., c1:])
        Bsz, T = xh.shape[:2]
        _, dw, dbias, dwin = conv_kernel.causal_conv_bwd(
            (dx.view(Bsz, T, d_inner), dB.view(Bsz, T, gn),
             dC.view(Bsz, T, gn)),
            zxbcdt[..., c0:c1], w, bias, window,
            g_add=dx_skip.view(Bsz, T, d_inner), dx_out=dzx[..., c0:c1])
        return (dzx, dw, dbias, ddt_bias, dA, dD, dscale, dwin, dh0, None)


def _split_proj(z, d_inner, ngroups, d_state, nheads):
    zs = [d_inner, d_inner, ngroups * d_state, ngroups * d_state, nheads]
    idx = [0]
    for s in zs:
        idx.append(idx[-1] + s)
    return tuple(z[..., idx[i]:idx[i + 1]] for i in range(5))


def mamba2_block(p: Params, x: torch.Tensor, *, d_state: int = 128,
                 headdim: int = 64, expand: int = 2, ngroups: int = 1,
                 conv_k: int = 4, chunk: int = 64,
                 dt: DTypes = DEFAULT_DTYPES, state=None,
                 return_state: bool = False,
                 residual: Optional[torch.Tensor] = None):
    """Full-sequence (training) Mamba-2 mixer.  x: (B, T, d).

    ``state`` / ``return_state``: optional (conv_state (B, K-1, conv_dim),
    ssm_state (B, H, P, N)) carried between sequence pieces.  ``residual``:
    added to the output projection (in its kernel on the card)."""
    Bsz, T, d_model = x.shape
    d_inner = expand * d_model
    nheads = d_inner // headdim
    zxbcdt = dense(p["in_proj"], x, dt)
    if build.on_card(zxbcdt):
        gn = ngroups * d_state
        win = None if state is None else state[0].to(dt.compute)
        h0 = state[1].float() if state is not None else None
        y, hf = _Mixer.apply(
            zxbcdt, p["conv_w"].to(dt.compute), p["conv_b"].to(dt.compute),
            p["dt_bias"], -torch.exp(p["A_log"].float()), p["D"],
            p["norm_scale"], win, h0,
            (d_inner, ngroups, d_state, headdim, chunk, dt.compute))
        out = dense(p["out_proj"], y, dt, residual=residual)
        if return_state:
            xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
            return out, (conv_kernel.window_of(xbc, win, conv_k).float(), hf)
        return out
    z, xi, Bc, Cc, dt_raw = _split_proj(zxbcdt, d_inner, ngroups, d_state,
                                        nheads)

    # causal depthwise conv over (x, B, C); prev conv window via `state`
    xbc = torch.cat([xi, Bc, Cc], dim=-1)
    conv, new_conv_state = conv_kernel.conv_silu(
        xbc, p["conv_w"], p["conv_b"], state[0] if state is not None else None,
        dt.compute)
    xi = conv[..., :d_inner]
    Bc = conv[..., d_inner:d_inner + ngroups * d_state]
    Cc = conv[..., d_inner + ngroups * d_state:]

    dts = dt_kernel.softplus_dt(dt_raw, p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(Bsz, T, nheads, headdim)
    Bg = Bc.reshape(Bsz, T, ngroups, d_state)
    Cg = Cc.reshape(Bsz, T, ngroups, d_state)
    h0 = state[1].float() if state is not None else None
    y, hf = ssd_chunked(xh, dts, A, Bg, Cg, chunk=chunk, h0=h0)
    # the D skip and the gated norm, cast to the compute dtype
    y = gate_kernel.gated_norm_out(y, xh, p["D"], z, p["norm_scale"],
                                   out_dtype=dt.compute)
    out = dense(p["out_proj"], y, dt, residual=residual)
    if return_state:
        return out, (new_conv_state.float(), hf)
    return out
