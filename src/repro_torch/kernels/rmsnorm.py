"""RMSNorm with a weight stored as an offset from 1, forward and backward
(``csrc/rmsnorm.cu``), optionally with the post-norm's residual add.

Replaces the arithmetic of ``repro/models/layers.py::rmsnorm`` and its vjp
inside the TPU kernels ``repro/kernels/segment_pallas.py``'s segments (a
decoder body traced into the ``pallas_call``).  :func:`rmsnorm_norm` is what the
model calls: on CUDA tensors an autograd function whose forward and
backward launch :func:`rmsnorm` and :func:`rmsnorm_bwd` (or raise), on any
other tensor the plain version :func:`rmsnorm_fwd_plain` (the JAX
package's operations one for one: the byte profile counts them on meta
tensors) under autograd, whose vjp is :func:`rmsnorm_bwd_plain`.
Launches count into ``rmsnorm.launches`` and ``rmsnorm_bwd.launches``
(the backward is two kernel launches a call, counted once).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("rmsnorm")
    lib.rmsnorm_fwd.restype = _I
    lib.rmsnorm_fwd.argtypes = [_P] * 5 + [_L, _I, _F, _I, _I, _P]
    lib.rmsnorm_bwd.restype = _I
    lib.rmsnorm_bwd.argtypes = [_P] * 7 + [_L, _I, _I, _I, _P]
    lib.rmsnorm_bwd_blocks.restype = _I
    lib.rmsnorm_bwd_blocks.argtypes = [_L]
    return lib


def _check(what, named, dtypes=DTYPES) -> None:
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{what}: {name} is {t.dtype}, not one of "
                             f"{list(dtypes)}")


def rmsnorm_fwd_plain(x: torch.Tensor, scale: torch.Tensor,
                      residual: Optional[torch.Tensor], eps: float,
                      out_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(residual + y or y, rstd)``: ``y = x rstd (1 + scale)`` in fp32,
    cast to ``out_dtype``; ``rstd`` (..., 1) fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf * rstd * (1.0 + scale.float())).to(out_dtype)
    if residual is not None:
        y = residual + y
    return y, rstd


def rmsnorm_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                      eps: float, out_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)``: the vjp of :func:`rmsnorm_fwd_plain`'s ``y`` (no
    residual) for the cotangent ``g``, by autograd over the plain forward
    recomputed -- the kernel's ``dx = rstd (g w - xh mean(g w xh))``,
    ``dscale = sum_rows g xh`` -- in x's and scale's dtypes."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        y, _ = rmsnorm_fwd_plain(xr, sr, None, eps, out_dtype)
        dx, dscale = torch.autograd.grad(y, (xr, sr), g)
    return dx, dscale


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            residual: Optional[torch.Tensor] = None, *, eps: float = 1e-6,
            out_dtype: Optional[torch.dtype] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (CUDA tensors only): ``(out, rstd)``, ``out`` in
    ``out_dtype`` (default x's) and x's shape, ``rstd`` fp32 (rows,)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not build.on_card(x):
        raise ValueError("rmsnorm runs on the card only")
    named = [("x", x), ("scale", scale)]
    if residual is not None:
        named.append(("residual", residual))
        if residual.shape != x.shape or residual.dtype != out_dtype:
            raise ValueError(f"rmsnorm: residual{tuple(residual.shape)} "
                             f"{residual.dtype} must be x's shape "
                             f"{tuple(x.shape)} in {out_dtype}")
    _check("rmsnorm", named)
    if out_dtype not in DTYPES:
        raise ValueError(f"rmsnorm: output dtype {out_dtype} is not one of "
                         f"{list(DTYPES)}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale{tuple(scale.shape)} must be "
                         f"({d},)")
    x = x.contiguous()
    sc = scale.float().contiguous()
    res = None if residual is None else residual.contiguous()
    rows = x.numel() // max(d, 1)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.rmsnorm_fwd(build.ptr(x), build.ptr(sc), build.ptr(res),
                          build.ptr(out), build.ptr(rstd), rows, d,
                          float(eps), int(x.dtype == torch.bfloat16),
                          int(out_dtype == torch.bfloat16),
                          build.stream_ptr(x.device))
    build.check(lib, err, "rmsnorm")
    rmsnorm.launches += 1
    return out, rstd


def rmsnorm_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel (CUDA tensors only): ``(dx, dscale)`` for the
    cotangent ``g`` of :func:`rmsnorm`'s ``y`` (a residual's cotangent is
    ``g`` itself), ``dx`` in x's dtype, ``dscale`` in scale's."""
    if not build.on_card(x):
        raise ValueError("rmsnorm_bwd runs on the card only")
    _check("rmsnorm_bwd", [("x", x), ("g", g), ("scale", scale),
                           ("rstd", rstd)])
    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    if g.shape != x.shape or rstd.numel() != rows \
            or rstd.dtype != torch.float32 or scale.shape != (d,):
        raise ValueError(f"rmsnorm_bwd: g{tuple(g.shape)}, "
                         f"rstd{tuple(rstd.shape)} {rstd.dtype}, "
                         f"scale{tuple(scale.shape)} do not fit "
                         f"x{tuple(x.shape)}")
    x, g = x.contiguous(), g.contiguous()
    sc = scale.float().contiguous()
    lib = _lib()
    part = torch.empty((lib.rmsnorm_bwd_blocks(rows), d),
                       dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    err = lib.rmsnorm_bwd(build.ptr(g), build.ptr(x), build.ptr(sc),
                          build.ptr(rstd), build.ptr(dx), build.ptr(part),
                          build.ptr(dscale), rows, d,
                          int(x.dtype == torch.bfloat16),
                          int(g.dtype == torch.bfloat16),
                          build.stream_ptr(x.device))
    build.check(lib, err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dscale.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    """The kernels as one autograd function (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, scale, residual, eps, out_dtype):
        out, rstd = rmsnorm(x, scale, residual, eps=eps, out_dtype=out_dtype)
        ctx.save_for_backward(x, scale, rstd)
        ctx.residual = residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(g, x, scale, rstd)
        return dx, dscale, (g if ctx.residual else None), None, None


def rmsnorm_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                 out_dtype: Optional[torch.dtype] = None,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x rsqrt(mean(x^2) + eps) (1 + scale)`` over the last axis, in
    ``out_dtype`` (default x's); with ``residual``, ``residual`` plus it.
    Differentiable in ``x``, ``scale`` and ``residual``: the kernels on the
    card, autograd over the plain forward elsewhere."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if build.on_card(x):
        return _RMSNorm.apply(x, scale, residual, eps, out_dtype)
    return rmsnorm_fwd_plain(x, scale, residual, eps, out_dtype)[0]


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
