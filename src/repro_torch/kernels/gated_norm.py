"""Mamba-2's output gate -- the D skip, the SiLU gate and the RMSNorm in one
pass -- forward and backward (``csrc/gated_norm.cu``).

Replaces the arithmetic of ``repro/models/ssm.py:202-204`` (the skip
``y + D x``, ``_gated_norm`` of ``:154-158`` and the cast to the compute
dtype) and its vjp inside the TPU kernels
``repro/kernels/segment_pallas.py``'s segments (a mamba2 body traced into
the ``pallas_call``).  :func:`gated_norm_out` is what the model calls: on
the card (``build.on_card``) an autograd function whose forward and
backward launch :func:`gated_norm` and :func:`gated_norm_bwd` (or raise),
elsewhere the plain version :func:`gated_norm_plain` (the JAX package's
operations one for one: the byte profile counts them on meta tensors)
under autograd, whose vjp is :func:`gated_norm_bwd_plain`.  Launches
count into ``gated_norm.launches`` and ``gated_norm_bwd.launches`` (the
backward is two kernel launches a call, counted once).

Shapes: ``y`` and ``x`` (B, T, H, P), ``D`` (H,), ``z`` and ``scale`` over
``H P`` columns; ``x`` and ``z`` may be column slices of wider rows (read
in place through their row stride).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("gated_norm")
    lib.gated_norm_fwd.restype = _I
    lib.gated_norm_fwd.argtypes = [_P] * 7 + [_L, _I, _I, _L, _L, _F, _I, _I,
                                              _P]
    lib.gated_norm_bwd.restype = _I
    lib.gated_norm_bwd.argtypes = [_P] * 13 + [_L, _I, _I, _L, _L, _L, _I,
                                               _I, _P]
    lib.gated_norm_bwd_blocks.restype = _I
    lib.gated_norm_bwd_blocks.argtypes = [_L]
    return lib


def gated_norm_plain(y: torch.Tensor, x: torch.Tensor, D: torch.Tensor,
                     z: torch.Tensor, scale: torch.Tensor, eps: float,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """``rmsnorm((y + D x) silu(z)) (1 + scale)`` in ``out_dtype``, (B, T,
    H P): the model's operations one for one."""
    Bsz, T = y.shape[:2]
    y = y + D.to(y.dtype)[None, None, :, None] * x
    y = y.reshape(Bsz, T, -1)
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)
            * (1.0 + scale.float())).to(out_dtype)


def gated_norm_bwd_plain(g, y, x, D, z, scale, eps, out_dtype):
    """``(dy, dx, dD, dz, dscale)``: the vjp of :func:`gated_norm_plain`
    for the cotangent ``g``, by autograd over the plain forward recomputed
    (``dx`` the skip's part only), each in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (y, x, D, z, scale)]
        out = gated_norm_plain(*ins[:4], ins[4], eps, out_dtype)
        return torch.autograd.grad(out, ins, g)


def _check(what, y, x, D, z, scale):
    if y.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"{what}: y{tuple(y.shape)} and x{tuple(x.shape)} "
                         "must be one (B, T, H, P) shape")
    Bsz, T, H, P = y.shape
    if D.shape != (H,) or z.shape != (Bsz, T, H * P) \
            or scale.shape != (H * P,):
        raise ValueError(f"{what}: D{tuple(D.shape)} z{tuple(z.shape)} "
                         f"scale{tuple(scale.shape)} do not fit "
                         f"y{tuple(y.shape)}")
    for name, t in (("y", y), ("x", x), ("z", z), ("D", D),
                    ("scale", scale)):
        if t.device != y.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{y.device}")
        if t.dtype not in DTYPES:
            raise ValueError(f"{what}: {name} is {t.dtype}, not one of "
                             f"{list(DTYPES)}")
    if x.dtype != y.dtype or z.dtype != y.dtype:
        raise ValueError(f"{what}: y, x and z must share a dtype (got "
                         f"{y.dtype}, {x.dtype}, {z.dtype})")


def gated_norm(y, x, D, z, scale, *, eps: float = 1e-6, out_dtype=None):
    """The forward kernel (card only): ``(out (B, T, H P) in out_dtype
    (default y's), rstd fp32 (B T,))``."""
    out_dtype = y.dtype if out_dtype is None else out_dtype
    if not build.on_card(y):
        raise ValueError("gated_norm runs on the card only")
    _check("gated_norm", y, x, D, z, scale)
    if out_dtype not in DTYPES:
        raise ValueError(f"gated_norm: output dtype {out_dtype} is not one "
                         f"of {list(DTYPES)}")
    Bsz, T, H, P = y.shape
    d = H * P
    yr = build.dense(y, "gated_norm: y")
    xr, sx = build.rows(x, d, "gated_norm: x")
    zr, sz = build.rows(z, d, "gated_norm: z")
    rows = xr.shape[0]
    Dv = D.to(y.dtype).float().contiguous()
    sc = scale.float().contiguous()
    out = torch.empty((Bsz, T, d), dtype=out_dtype, device=y.device)
    rstd = torch.empty((rows,), dtype=torch.float32, device=y.device)
    lib = _lib()
    err = lib.gated_norm_fwd(
        build.ptr(yr), build.ptr(xr), build.ptr(zr), build.ptr(Dv),
        build.ptr(sc), build.ptr(out), build.ptr(rstd), rows, d, P, sx, sz,
        float(eps), int(y.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), build.stream_ptr(y.device))
    build.check(lib, err, "gated_norm")
    gated_norm.launches += 1
    return out, rstd


def gated_norm_bwd(g, y, x, D, z, scale, rstd, *, dz_out=None):
    """The backward kernel (card only): ``(dy, dx, dD, dz, dscale)`` for
    the cotangent ``g`` of :func:`gated_norm`'s output, each in its
    input's dtype (``dx`` the skip's part; ``dD`` rounded to y's dtype
    first, as the plain version's sum is).  ``dz_out``: the view (rows
    with one stride, z's shape and dtype) that takes ``dz``."""
    if not build.on_card(y):
        raise ValueError("gated_norm_bwd runs on the card only")
    _check("gated_norm_bwd", y, x, D, z, scale)
    Bsz, T, H, P = y.shape
    d = H * P
    if g.shape != (Bsz, T, d) or g.dtype not in DTYPES \
            or rstd.shape != (Bsz * T,) or rstd.dtype != torch.float32:
        raise ValueError(f"gated_norm_bwd: g{tuple(g.shape)} {g.dtype}, "
                         f"rstd{tuple(rstd.shape)} {rstd.dtype} do not fit "
                         f"y{tuple(y.shape)}")
    yr = build.dense(y, "gated_norm_bwd: y")
    gr = build.dense(g, "gated_norm_bwd: g")
    xr, sx = build.rows(x, d, "gated_norm_bwd: x")
    zr, sz = build.rows(z, d, "gated_norm_bwd: z")
    rows = xr.shape[0]
    Dv = D.to(y.dtype).float().contiguous()
    sc = scale.float().contiguous()
    lib = _lib()
    part = torch.empty((lib.gated_norm_bwd_blocks(rows), 2 * d),
                       dtype=torch.float32, device=y.device)
    dy = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    dx = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    if dz_out is None:
        dz_out = torch.empty((Bsz, T, d), dtype=z.dtype, device=y.device)
    elif dz_out.shape != z.shape or dz_out.dtype != z.dtype:
        raise ValueError(f"gated_norm_bwd: dz_out{tuple(dz_out.shape)} "
                         f"{dz_out.dtype} is not z's {tuple(z.shape)} "
                         f"{z.dtype}")
    dzr, sdz = build.rows(dz_out, d, "gated_norm_bwd: dz_out")
    dscale = torch.empty((d,), dtype=torch.float32, device=y.device)
    dD = torch.empty((H,), dtype=torch.float32, device=y.device)
    err = lib.gated_norm_bwd(
        build.ptr(gr), build.ptr(yr), build.ptr(xr), build.ptr(zr),
        build.ptr(Dv), build.ptr(sc), build.ptr(rstd), build.ptr(dy),
        build.ptr(dx), build.ptr(dzr), build.ptr(part), build.ptr(dscale),
        build.ptr(dD), rows, d, P, sx, sz, sdz,
        int(y.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
        build.stream_ptr(y.device))
    build.check(lib, err, "gated_norm_bwd")
    gated_norm_bwd.launches += 1
    return (dy, dx, dD.to(y.dtype).to(D.dtype), dz_out,
            dscale.to(scale.dtype))


class _GatedNorm(torch.autograd.Function):
    """The kernels as one autograd function (card tensors)."""

    @staticmethod
    def forward(ctx, y, x, D, z, scale, eps, out_dtype):
        out, rstd = gated_norm(y, x, D, z, scale, eps=eps,
                               out_dtype=out_dtype)
        ctx.save_for_backward(y, x, D, z, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*gated_norm_bwd(build.cotangent(g), *ctx.saved_tensors),
                None, None)


def gated_norm_out(y: torch.Tensor, x: torch.Tensor, D: torch.Tensor,
                   z: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                   out_dtype=None) -> torch.Tensor:
    """``rmsnorm((y + D x) silu(z)) (1 + scale)`` in ``out_dtype`` (default
    y's), (B, T, H P); differentiable in all five.  The kernels on the
    card, autograd over the plain forward elsewhere."""
    out_dtype = y.dtype if out_dtype is None else out_dtype
    if build.on_card(y):
        return _GatedNorm.apply(y, x, D, z, scale, eps, out_dtype)
    return gated_norm_plain(y, x, D, z, scale, eps, out_dtype)


gated_norm.launches = 0
gated_norm_bwd.launches = 0
