"""Mamba-2's step sizes ``softplus(dt_raw + dt_bias)`` in fp32, forward and
backward (``csrc/dt_softplus.cu``).

Replaces the arithmetic of ``repro/models/ssm.py:194-195`` and its vjp
inside the TPU kernels ``repro/kernels/segment_pallas.py``'s segments (a
mamba2 body traced into the ``pallas_call``).  :func:`softplus_dt` is what
the model calls: on the card (``build.on_card``) an autograd function whose
forward and backward launch :func:`dt_softplus` and :func:`dt_softplus_bwd`
(or raise), elsewhere the plain version :func:`dt_softplus_plain` (the JAX
package's operations one for one) under autograd, whose vjp is
:func:`dt_softplus_bwd_plain`.  Launches count into
``dt_softplus.launches`` and ``dt_softplus_bwd.launches`` (the backward
is two kernel launches a call, counted once).

Shapes: ``dt_raw`` (B, T, H), possibly a column slice of wider rows (read
in place through its row stride), ``dt_bias`` (H,); the result (B, T, H)
fp32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("dt_softplus")
    lib.dt_softplus_fwd.restype = _I
    lib.dt_softplus_fwd.argtypes = [_P] * 3 + [_L, _I, _L, _I, _P]
    lib.dt_softplus_bwd.restype = _I
    lib.dt_softplus_bwd.argtypes = [_P] * 5 + [_L, _I, _L, _L, _I, _P]
    return lib


def dt_softplus_plain(dt_raw: torch.Tensor,
                      dt_bias: torch.Tensor) -> torch.Tensor:
    """``softplus(dt_raw + dt_bias)`` in fp32: the model's operations."""
    return F.softplus(dt_raw.float() + dt_bias.float())


def dt_softplus_bwd_plain(g, dt_raw, dt_bias):
    """``(d dt_raw, d dt_bias)``: the vjp of :func:`dt_softplus_plain` for
    the cotangent ``g``, by autograd, in the inputs' dtypes."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (dt_raw, dt_bias)]
        return torch.autograd.grad(dt_softplus_plain(*ins), ins, g)


def _check(what, dt_raw, dt_bias):
    if dt_raw.dim() != 3 or dt_bias.shape != (dt_raw.shape[-1],):
        raise ValueError(f"{what}: dt_raw{tuple(dt_raw.shape)} "
                         f"dt_bias{tuple(dt_bias.shape)} do not fit (B, T, "
                         "H), (H,)")
    for name, t in (("dt_raw", dt_raw), ("dt_bias", dt_bias)):
        if t.device != dt_raw.device or t.dtype not in DTYPES:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected one of {list(DTYPES)} on "
                             f"{dt_raw.device}")


def dt_softplus(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """The forward kernel (card only): ``softplus(dt_raw + dt_bias)``
    (B, T, H) fp32."""
    if not build.on_card(dt_raw):
        raise ValueError("dt_softplus runs on the card only")
    _check("dt_softplus", dt_raw, dt_bias)
    r, sr = build.rows(dt_raw, dt_raw.shape[-1], "dt_softplus: dt_raw")
    out = torch.empty(dt_raw.shape, dtype=torch.float32,
                      device=dt_raw.device)
    lib = _lib()
    err = lib.dt_softplus_fwd(
        build.ptr(r), build.ptr(dt_bias.float().contiguous()),
        build.ptr(out), r.shape[0], r.shape[1], sr,
        int(dt_raw.dtype == torch.bfloat16), build.stream_ptr(dt_raw.device))
    build.check(lib, err, "dt_softplus")
    dt_softplus.launches += 1
    return out


def dt_softplus_bwd(g: torch.Tensor, dt_raw: torch.Tensor,
                    dt_bias: torch.Tensor, *,
                    draw_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel (card only): ``(d dt_raw, d dt_bias)`` for the
    fp32 cotangent ``g`` of :func:`dt_softplus`'s output, in the inputs'
    dtypes; ``draw_out``: the view (rows with one stride, dt_raw's shape
    and dtype) that takes ``d dt_raw``, which is then returned."""
    if not build.on_card(dt_raw):
        raise ValueError("dt_softplus_bwd runs on the card only")
    _check("dt_softplus_bwd", dt_raw, dt_bias)
    if g.shape != dt_raw.shape or g.dtype != torch.float32:
        raise ValueError(f"dt_softplus_bwd: g{tuple(g.shape)} {g.dtype} is "
                         f"not dt_raw's shape {tuple(dt_raw.shape)} in fp32")
    H = dt_raw.shape[-1]
    r, sr = build.rows(dt_raw, H, "dt_softplus_bwd: dt_raw")
    if draw_out is None:
        draw_out = torch.empty(dt_raw.shape, dtype=dt_raw.dtype,
                               device=dt_raw.device)
    elif draw_out.shape != dt_raw.shape or draw_out.dtype != dt_raw.dtype:
        raise ValueError(f"dt_softplus_bwd: draw_out"
                         f"{tuple(draw_out.shape)} {draw_out.dtype} is not "
                         f"dt_raw's {tuple(dt_raw.shape)} {dt_raw.dtype}")
    dr, sd = build.rows(draw_out, H, "dt_softplus_bwd: draw_out")
    dbias = torch.empty(dt_bias.shape, dtype=torch.float32,
                        device=dt_raw.device)
    lib = _lib()
    err = lib.dt_softplus_bwd(
        build.ptr(r), build.ptr(dt_bias.float().contiguous()),
        build.ptr(build.dense(g, "dt_softplus_bwd: g")), build.ptr(dr),
        build.ptr(dbias), r.shape[0], r.shape[1], sr, sd,
        int(dt_raw.dtype == torch.bfloat16), build.stream_ptr(dt_raw.device))
    build.check(lib, err, "dt_softplus_bwd")
    dt_softplus_bwd.launches += 1
    return draw_out, dbias.to(dt_bias.dtype)


class _DtSoftplus(torch.autograd.Function):
    """The kernels as one autograd function (card tensors)."""

    @staticmethod
    def forward(ctx, dt_raw, dt_bias):
        ctx.save_for_backward(dt_raw, dt_bias)
        return dt_softplus(dt_raw, dt_bias)

    @staticmethod
    def backward(ctx, g):
        return dt_softplus_bwd(build.cotangent(g), *ctx.saved_tensors)


def softplus_dt(dt_raw: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """``softplus(dt_raw + dt_bias)`` in fp32, differentiable in both: the
    kernels on the card, autograd over the plain forward elsewhere."""
    if build.on_card(dt_raw):
        return _DtSoftplus.apply(dt_raw, dt_bias)
    return dt_softplus_plain(dt_raw, dt_bias)


dt_softplus.launches = 0
dt_softplus_bwd.launches = 0
