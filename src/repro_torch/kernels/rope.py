"""Rotary position embedding (rotate-half), forward and backward, of q and
k in one launch (``csrc/rope.cu``).

Replaces the arithmetic of ``repro/models/layers.py::apply_rope`` and its
vjp inside the TPU kernels ``repro/kernels/segment_pallas.py``'s segments
(a decoder body traced into the ``pallas_call``).  :func:`rope_apply` is
what the model calls on one tensor or on q and k together: on CUDA tensors
an autograd function whose forward and backward launch :func:`rope` and
:func:`rope_bwd` (the rotation by -theta) or raise, on any other tensor the
plain version :func:`rope_plain` (the JAX package's operations) under
autograd, whose vjp is :func:`rope_bwd_plain`.  The backward kernel rounds
each cotangent once; autograd over the plain version rounds the two
products of a half apart in bf16 (equal bits in fp32).  Launches count
into ``rope.launches`` (forward) and ``rope_bwd.launches``.

:func:`rope_apply_theta` is the same rotation with the angles computed in
the kernel from the position and ``theta`` (``models/layers.py::
rope_table``'s formula in fp32), so a layer on the card makes no
``(S, D/2)`` table: held to the plain table's rotation within the rope
tolerance, not its bits (the device's ``powf``, ``cosf`` and ``sinf``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("rope")
    lib.rope.restype = _I
    lib.rope.argtypes = [_P, _P, _L, _I, _P, _P, _L, _I, _P, _P, _F, _I, _I,
                         _I, _I, _P]
    return lib


def rope_plain(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) — rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[..., :, None, :]  # (S, 1, D/2) broadcast over heads
    sin = sin[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope_bwd_plain(g: torch.Tensor, x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
    """The cotangent of :func:`rope_plain`'s ``x`` for ``g`` (the rotation
    by -theta), by autograd over it recomputed, in x's dtype."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        return torch.autograd.grad(rope_plain(xr, cos, sin), xr, g)[0]


def _launch(xs: Sequence[torch.Tensor], cos, sin, inverse: bool, what: str,
            theta: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """One launch over ``xs``; ``cos``/``sin`` the table, or both None and
    the angles from ``theta``."""
    if not build.on_card(xs[0]):
        raise ValueError(f"{what} runs on the card only")
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"{what}: one or two tensors (q, k), not {len(xs)}")
    x0 = xs[0]
    if x0.dim() < 3:
        raise ValueError(f"{what}: x{tuple(x0.shape)} is not (..., S, H, D)")
    S, D = x0.shape[-3], x0.shape[-1]
    if (cos is None) != (theta is not None) or (cos is None) != (sin is None):
        raise ValueError(f"{what}: a table (cos, sin) or theta")
    for name, t in (("cos", cos), ("sin", sin)):
        if t is None:
            continue
        if t.shape != (S, D // 2) or t.dtype != torch.float32 \
                or t.device != x0.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name}{tuple(t.shape)} {t.dtype} "
                             f"must be contiguous fp32 ({S}, {D // 2}) on "
                             f"{x0.device}")
    for x in xs:
        if x.dim() < 3 or x.shape[-3] != S or x.shape[-1] != D or D % 2 \
                or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(f"{what}: x{tuple(x.shape)} {x.dtype} does not "
                             f"fit (..., {S}, H, {D}) {x0.dtype}, D even")
    if x0.dtype not in DTYPES:
        raise ValueError(f"{what}: dtype {x0.dtype} is not one of "
                         f"{list(DTYPES)}")
    xs = [build.dense(x, what) for x in xs]
    ys = [torch.empty_like(x) for x in xs]
    args = []
    for i in range(2):
        if i < len(xs):
            args += [build.ptr(xs[i]), build.ptr(ys[i]), xs[i].numel() // 2,
                     xs[i].shape[-2]]
        else:
            args += [build.ptr(None), build.ptr(None), 0, 0]
    lib = _lib()
    err = lib.rope(*args, build.ptr(cos), build.ptr(sin),
                   0.0 if theta is None else float(theta), S, D // 2,
                   int(inverse),
                   int(x0.dtype == torch.bfloat16),
                   build.stream_ptr(x0.device))
    build.check(lib, err, what)
    return tuple(ys)


def rope(xs: Sequence[torch.Tensor], cos: Optional[torch.Tensor],
         sin: Optional[torch.Tensor], *, theta: Optional[float] = None
         ) -> Tuple[torch.Tensor, ...]:
    """The forward kernel (CUDA tensors only): each of ``xs`` (one or two,
    (..., S, H, D), one dtype) rotated, in one launch, by the table
    ``cos``, ``sin`` or (both None) by the angles of ``theta``."""
    ys = _launch(xs, cos, sin, False, "rope", theta)
    rope.launches += 1
    return ys


def rope_bwd(gs: Sequence[torch.Tensor], cos: Optional[torch.Tensor],
             sin: Optional[torch.Tensor], *, theta: Optional[float] = None
             ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel (CUDA tensors only): each cotangent rotated by
    -theta, in one launch."""
    ys = _launch(gs, cos, sin, True, "rope_bwd", theta)
    rope_bwd.launches += 1
    return ys


class _Rope(torch.autograd.Function):
    """The kernels as one autograd function (CUDA tensors): the table's
    rotation, or (``cos`` None) the angles of ``theta``."""

    @staticmethod
    def forward(ctx, cos, sin, theta, *xs):
        ctx.save_for_backward(cos, sin)
        ctx.theta = theta
        return rope(xs, cos, sin, theta=theta)

    @staticmethod
    def backward(ctx, *gs):
        cos, sin = ctx.saved_tensors
        return (None, None, None,
                *rope_bwd([build.cotangent(g) for g in gs], cos, sin,
                          theta=ctx.theta))


def rope_apply(cos: torch.Tensor, sin: torch.Tensor,
               *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` ((..., S, H, D): q and k) rotated by the ``(S, D/2)``
    table; differentiable in ``xs``: one kernel launch each way on the
    card, autograd over the plain version elsewhere."""
    if build.on_card(xs[0]):
        return _Rope.apply(cos, sin, None, *xs)
    return tuple(rope_plain(x, cos, sin) for x in xs)


def rope_table_plain(seq_len: int, half: int, theta: float, device=None,
                     dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` (seq_len, half): the rotary table of positions ``0 ..
    seq_len - 1`` (``models/layers.py::rope_table``), the one
    :func:`rope_apply_theta` computes in its kernel (in fp32)."""
    freqs = theta ** (-torch.arange(0, half, dtype=dtype, device=device)
                      / half)
    angles = torch.arange(seq_len, dtype=dtype,
                          device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def rope_apply_theta(theta: float, *xs: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """:func:`rope_apply` by the table of positions ``0 .. S - 1`` and
    ``theta``: on the card the angles computed in the kernel (no table is
    made), elsewhere the plain version on :func:`rope_table_plain`."""
    if build.on_card(xs[0]):
        return _Rope.apply(None, None, float(theta), *xs)
    cos, sin = rope_table_plain(xs[0].shape[-3], xs[0].shape[-1] // 2,
                                theta, xs[0].device)
    return tuple(rope_plain(x, cos, sin) for x in xs)


rope.launches = 0
rope_bwd.launches = 0
