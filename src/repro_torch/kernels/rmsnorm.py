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

:func:`rmsnorm_fanout` is a pre-norm's form: the normed output for up to
three consumers (the attention's q, k and v projections, an MLP's gate and
up, a MoE layer's router and dispatch) and the input passed on as the
skip (the residual), so that on the card the cotangents autograd would
sum -- the consumers' and the skip's -- meet inside the backward kernel
(:func:`rmsnorm_bwd`'s ``g_more`` and ``dskip``), each add rounded as
autograd's; elsewhere it is the plain forward and its input, and autograd
sums them as before.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("rmsnorm")
    lib.rmsnorm_fwd.restype = _I
    lib.rmsnorm_fwd.argtypes = [_P] * 5 + [_L, _I, _F, _I, _I, _P]
    lib.rmsnorm_bwd.restype = _I
    lib.rmsnorm_bwd.argtypes = [_P] * 10 + [_L, _I, _I, _I, _P]
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
    x = build.dense(x, "rmsnorm: x")
    sc = scale.float().contiguous()
    res = build.dense(residual, "rmsnorm: residual")
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
                rstd: torch.Tensor, *, g_more: Sequence[torch.Tensor] = (),
                dskip: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel (CUDA tensors only): ``(dx, dscale)`` for the
    cotangent ``g`` of :func:`rmsnorm`'s ``y`` (a residual's cotangent is
    ``g`` itself), ``dx`` in x's dtype, ``dscale`` in scale's.  ``g_more``:
    up to two more consumers' cotangents of ``y``, summed into ``g`` in
    order, each add rounded to g's dtype; ``dskip``: the cotangent of the
    input passed on as a skip, added to ``dx`` after its rounding (the
    plain version's ``autograd`` sums)."""
    if not build.on_card(x):
        raise ValueError("rmsnorm_bwd runs on the card only")
    g_more = list(g_more)
    if len(g_more) > 2:
        raise ValueError("rmsnorm_bwd: at most three consumers' cotangents")
    named = [("x", x), ("g", g), ("scale", scale), ("rstd", rstd)]
    named += [(f"g_more[{i}]", t) for i, t in enumerate(g_more)]
    if dskip is not None:
        named.append(("dskip", dskip))
    _check("rmsnorm_bwd", named)
    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    if g.shape != x.shape or rstd.numel() != rows \
            or rstd.dtype != torch.float32 or scale.shape != (d,) \
            or any(t.shape != g.shape or t.dtype != g.dtype
                   for t in g_more) \
            or (dskip is not None and (dskip.shape != x.shape
                                       or dskip.dtype != x.dtype)):
        raise ValueError(f"rmsnorm_bwd: g{tuple(g.shape)} {g.dtype}, "
                         f"rstd{tuple(rstd.shape)} {rstd.dtype}, "
                         f"scale{tuple(scale.shape)}, the other "
                         "cotangents and the skip's do not fit "
                         f"x{tuple(x.shape)} {x.dtype}")
    for name, t in named[:2] + named[4:]:
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm_bwd: {name} must be contiguous")
    sc = scale.float().contiguous()
    lib = _lib()
    part = torch.empty((lib.rmsnorm_bwd_blocks(rows), d),
                       dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    gs = [g] + g_more + [None] * (2 - len(g_more))
    err = lib.rmsnorm_bwd(*[build.ptr(t) for t in gs], build.ptr(x),
                          build.ptr(sc), build.ptr(rstd), build.ptr(dskip),
                          build.ptr(dx), build.ptr(part), build.ptr(dscale),
                          rows, d, int(x.dtype == torch.bfloat16),
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
        dx, dscale = rmsnorm_bwd(build.cotangent(g), x, scale, rstd)
        return dx, dscale, (g if ctx.residual else None), None, None


class _RMSNormFanout(torch.autograd.Function):
    """The kernels as one autograd function (CUDA tensors) with ``n`` equal
    outputs and the input passed on as a skip: ``(y, ..., y, x)``.  Its
    backward sums the outputs' cotangents and adds the skip's inside the
    backward kernel (a missing cotangent is left out)."""

    @staticmethod
    def forward(ctx, x, scale, eps, out_dtype, n):
        out, rstd = rmsnorm(x, scale, eps=eps, out_dtype=out_dtype)
        ctx.save_for_backward(x, scale, rstd)
        ctx.set_materialize_grads(False)
        outs = [out] + [out.view_as(out) for _ in range(n - 1)]
        return (*outs, x.view_as(x))

    @staticmethod
    def backward(ctx, *cots):
        x, scale, rstd = ctx.saved_tensors
        gs = [build.cotangent(g) for g in cots[:-1] if g is not None]
        dskip = build.cotangent(cots[-1])
        if not gs:
            return dskip, None, None, None, None
        dx, dscale = rmsnorm_bwd(gs[0], x, scale, rstd, g_more=gs[1:],
                                 dskip=dskip)
        return dx, dscale, None, None, None


def rmsnorm_fanout(x: torch.Tensor, scale: torch.Tensor, n: int = 1, *,
                   eps: float = 1e-6,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """``(y, ..., y, x)``: :func:`rmsnorm_norm`'s ``y`` for ``n`` (1 to 3)
    consumers and ``x`` for the skip.  On the card one autograd function
    whose backward sums the consumers' cotangents and the skip's in the
    backward kernel; elsewhere the plain forward, ``n`` times the same
    tensor, and ``x`` itself."""
    if not 1 <= n <= 3:
        raise ValueError(f"rmsnorm_fanout: {n} consumers, 1 to 3 taken")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if build.on_card(x):
        return _RMSNormFanout.apply(x, scale, eps, out_dtype, n)
    y = rmsnorm_fwd_plain(x, scale, None, eps, out_dtype)[0]
    return (*([y] * n), x)


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
