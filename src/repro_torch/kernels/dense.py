"""The models' projections ``x @ w.to(compute)`` and their vjp
(``csrc/dense.cu``): one GEMM with the fp32-to-bf16 weight cast done in its
load, and the backward's ``dx = dy @ w^T`` and ``dw = x^T @ dy``.

Replaces the arithmetic of ``repro/models/layers.py::dense`` and its vjp
inside the TPU kernels ``repro/kernels/segment_pallas.py``'s segments (a
decoder body traced into the ``pallas_call``).  :func:`project` is what
``models/layers.py::dense`` calls: on CUDA tensors the autograd function
:class:`_Dense`, whose forward and backward launch :func:`dense_fwd` and
:func:`dense_bwd` (or raise), on any other tensor ``x @ w.to(compute)``
under autograd, the plain version :func:`dense_fwd_plain` (vjp
:func:`dense_bwd_plain`).  :class:`_Dense` saves ``x`` and the parameter
``w`` as it is stored (no bf16 copy); ``dw`` comes back in ``w``'s dtype,
the bf16 product's value (autograd's for the cast's backward), and is
skipped when ``w`` needs no gradient.  bf16 ``x`` runs on the tensor
cores (the Hopper form, ``wgmma`` on TMA-fed tiles, where TMA can take the
operands: bases 16-byte aligned, row strides and N multiples of 8; an fp32
``w`` is the register operand, rounded in registers, for a product of
fewer than ``W32_ROWS`` rows, and is rounded into a bf16 scratch for the
call first for the others; a ``dw`` whose tiles do not fill the card is
split over M into fp32 partials summed in a second pass; both scratches
allocated here); fp32 ``x`` (an fp32-compute model) a SIMT fp32 product.  Launches count into ``dense_fwd.launches`` and
``dense_bwd.launches`` (the backward is one or two products a call,
counted once); the products of bf16 ``x`` whose operands TMA cannot take
run the Ampere form (``mma.sync``) and count into ``dense_fwd.mma_sync``
and ``dense_bwd.mma_sync`` too (one a product).

The same kernels batched over a MoE layer's experts (one expert a
``blockIdx.z``): :func:`expert_fwd` and :func:`expert_bwd` on the
expert-major buckets (E, G C, d) of ``models/moe.py``, replacing the three
einsums of ``repro/models/moe.py::_expert_ffn`` and their vjps;
:func:`project_experts` is what ``_expert_ffn`` calls, :class:`_Experts`
its autograd function, ``expert_fwd_plain`` / ``expert_bwd_plain`` the
plain versions; launches in ``expert_fwd.launches`` and
``expert_bwd.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)
# the most columns of w, and rows of w (dx's columns), a launch takes:
# 65535 tiles of 64; the most experts a batched launch takes (gridDim.z)
MAX_W = 65535 * 64
MAX_BATCH = 65535


def _lib():
    lib = build.load("dense")
    # ..., batch, the batch strides of the three operands, the Hopper
    # form's flag and scratch, stream
    shape = [_I] * 5 + [_I, _L, _L, _L, _I]
    lib.dense_fwd.restype = _I
    lib.dense_fwd.argtypes = [_P, _L, _P, _P, _P] + shape + [_P, _P]
    lib.dense_dx.restype = _I
    lib.dense_dx.argtypes = [_P, _L, _P, _P] + shape + [_P, _P]
    lib.dense_dw.restype = _I
    lib.dense_dw.argtypes = [_P, _L, _P, _L, _P] + shape + [_I, _P, _P]
    lib.dense_dw_slices.restype = _I
    lib.dense_dw_slices.argtypes = [_I] * 4
    lib.dense_dw_reduce.restype = _I
    lib.dense_dw_reduce.argtypes = [_P, _P] + [_I] * 6 + [_L, _P]
    return lib


def _tma(*rows) -> bool:
    """Whether TMA can read each bf16 operand ``(t, row stride, batch
    stride)``: its base 16-byte aligned, its strides multiples of 8
    elements (16 bytes)."""
    return all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
               and ld % 8 == 0 and sb % 8 == 0 for t, ld, sb in rows)


# an fp32 weight's products with fewer rows than this (per batch element)
# read it as the register A operand, rounding in registers; the others
# round it into a bf16 copy for the call first: the copy's bytes (6 a
# weight) are a large share of a product with few rows, the register form
# retires each stage before loading the next (phase timing times both)
W32_ROWS = 4096


def _w_scratch(w: torch.Tensor, tma: bool, rows: int,
               out_cols: Optional[int] = None) -> Optional[torch.Tensor]:
    """The bf16 copy of an fp32 ``w`` for one call of the Hopper form
    (``rows`` rows of x a weight), or None where the call reads ``w`` itself:
    a bf16 weight, and an fp32 one read as the register operand (fewer than
    ``W32_ROWS`` rows, a 16-byte aligned base, and for dx ``out_cols``, dx's
    row, a multiple of 8)."""
    if not tma or w.dtype == torch.bfloat16:
        return None
    if rows < W32_ROWS and w.data_ptr() % 16 == 0 and (
            out_cols is None or out_cols % 8 == 0):
        return None
    return torch.empty(w.shape, dtype=torch.bfloat16, device=w.device)


def _w_ok(w: torch.Tensor, N: int) -> bool:
    """w as the Hopper form reads it: N a multiple of 8, a bf16 w's base
    aligned (an fp32 one's alignment picks its form, ``_w_scratch``)."""
    return N % 8 == 0 and (w.dtype == torch.float32
                           or w.data_ptr() % 16 == 0)


def _dw_part(lib, M: int, K: int, N: int, batch: int, device
             ) -> Tuple[int, Optional[torch.Tensor]]:
    """dw's split over M on the Hopper form and its fp32 partials' scratch
    (None for one slice)."""
    slices = lib.dense_dw_slices(M, K, N, batch)
    if slices <= 1:
        return 1, None
    return slices, torch.empty((batch, slices, K, N), dtype=torch.float32,
                               device=device)


ONE = (1, 0, 0, 0)   # one product: no batch strides


def _check(what, x, w, dy=None) -> None:
    for name, t in (("x", x), ("w", w), ("dy", dy)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype not in DTYPES:
            raise ValueError(f"{what}: {name} is {t.dtype}, not one of "
                             f"{list(DTYPES)}")
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{what}: x{tuple(x.shape)} @ w{tuple(w.shape)}: "
                         "w must be (K, N) and x (..., K)")
    if dy is not None and (dy.dtype != x.dtype or dy.shape[:-1]
                           != x.shape[:-1] or dy.shape[-1] != w.shape[1]):
        raise ValueError(f"{what}: dy{tuple(dy.shape)} {dy.dtype} does not "
                         f"fit x{tuple(x.shape)} {x.dtype} @ "
                         f"w{tuple(w.shape)}")
    if max(w.shape) > MAX_W:
        raise ValueError(f"{what}: w{tuple(w.shape)}: at most {MAX_W} rows "
                         "and columns a launch")


def dense_fwd_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.to(x.dtype)``: the JAX package's ``dense`` without a bias
    (with a residual, ``residual +`` it)."""
    return x @ w.to(x.dtype)


def dense_bwd_plain(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)``: the vjp of :func:`dense_fwd_plain` for ``dy`` by
    autograd over it recomputed, ``dx`` in x's dtype, ``dw`` in w's."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        wr = w.detach().requires_grad_(True)
        return torch.autograd.grad(dense_fwd_plain(xr, wr), (xr, wr), dy)


def dense_fwd(x: torch.Tensor, w: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel (CUDA tensors only): ``x @ w.to(x.dtype)``, x
    (..., K) and w (K, N) each fp32 or bf16, in x's dtype; with
    ``residual`` (contiguous, the output's shape and dtype) added in the
    epilogue, the product rounded first."""
    if not build.on_card(x):
        raise ValueError("dense_fwd runs on the card only")
    _check("dense_fwd", x, w)
    K, N = w.shape
    x2, ldx = build.rows(x, K, "dense_fwd: x")
    w = build.dense(w, "dense_fwd: w")
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    if residual is not None and (residual.shape != y.shape
                                 or residual.dtype != y.dtype
                                 or residual.device != y.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"dense_fwd: residual{tuple(residual.shape)} "
                         f"{residual.dtype} must be contiguous "
                         f"{tuple(y.shape)} {y.dtype}")
    lib = _lib()
    bf = x.dtype == torch.bfloat16
    tma = bf and K > 0 and _w_ok(w, N) and _tma((x2, ldx, 0))
    wbuf = _w_scratch(w, tma, x2.shape[0])
    err = lib.dense_fwd(build.ptr(x2), ldx, build.ptr(w), build.ptr(y),
                        build.ptr(residual), x2.shape[0], K, N, int(bf),
                        int(w.dtype == torch.bfloat16), *ONE, int(tma),
                        build.ptr(wbuf), build.stream_ptr(x.device))
    build.check(lib, err, "dense_fwd")
    dense_fwd.launches += 1
    if bf and not tma:
        dense_fwd.mma_sync += 1
    return y


def dense_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
              need_dx: bool = True, need_dw: bool = True
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernels (CUDA tensors only): ``(dx, dw)`` for the
    cotangent ``dy`` of :func:`dense_fwd`, ``dx`` in x's dtype, ``dw`` (the
    sum over every row of x) in w's; either is None where not needed."""
    if not build.on_card(x):
        raise ValueError("dense_bwd runs on the card only")
    _check("dense_bwd", x, w, dy)
    K, N = w.shape
    x_bf16, w_bf16 = int(x.dtype == torch.bfloat16), \
        int(w.dtype == torch.bfloat16)
    dy2, lddy = build.rows(dy, N, "dense_bwd: dy")
    M = dy2.shape[0]
    stream = build.stream_ptr(x.device)
    lib = _lib()
    dx = dw = None
    if need_dx:
        w = build.dense(w, "dense_bwd: w")
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        tma = x_bf16 and _w_ok(w, N) and _tma((dy2, lddy, 0))
        wbuf = _w_scratch(w, tma, M, K)
        err = lib.dense_dx(build.ptr(dy2), lddy, build.ptr(w), build.ptr(dx),
                           M, K, N, x_bf16, w_bf16, *ONE, int(tma),
                           build.ptr(wbuf), stream)
        build.check(lib, err, "dense_bwd (dx)")
        if x_bf16 and not tma:
            dense_bwd.mma_sync += 1
    if need_dw:
        x2, ldx = build.rows(x, K, "dense_bwd: x")
        dw = torch.empty((K, N), dtype=w.dtype, device=x.device)
        tma = x_bf16 and M > 0 and _tma((x2, ldx, 0), (dy2, lddy, 0))
        slices, part = _dw_part(lib, M, K, N, 1, x.device) if tma \
            else (1, None)
        err = lib.dense_dw(build.ptr(x2), ldx, build.ptr(dy2), lddy,
                           build.ptr(dw), M, K, N, x_bf16, w_bf16, *ONE,
                           int(tma), slices, build.ptr(part), stream)
        build.check(lib, err, "dense_bwd (dw)")
        if x_bf16 and not tma:
            dense_bwd.mma_sync += 1
    dense_bwd.launches += 1
    return dx, dw


class _Dense(torch.autograd.Function):
    """The kernels as one autograd function (CUDA tensors): saves ``x`` and
    ``w`` as given; a residual's cotangent is ``dy`` itself."""

    @staticmethod
    def forward(ctx, x, w, residual):
        ctx.save_for_backward(x, w)
        return dense_fwd(x, w, residual)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = build.cotangent(dy)
        dx, dw = dense_bwd(dy, x, w, need_dx=ctx.needs_input_grad[0],
                           need_dw=ctx.needs_input_grad[1])
        return dx, dw, (dy if ctx.needs_input_grad[2] else None)


def project(x: torch.Tensor, w: torch.Tensor, compute: torch.dtype,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.to(compute)`` (with ``residual``, ``residual`` plus it),
    differentiable in all three: the kernels on the card (where x must
    already be in ``compute``), the plain version under autograd
    elsewhere."""
    if build.on_card(x):
        if x.dtype != compute:
            raise ValueError(f"dense: x is {x.dtype}, the compute dtype "
                             f"{compute}")
        return _Dense.apply(x, w, residual)
    y = x @ w.to(compute)
    return y if residual is None else residual + y


# ------------------------------------------------ the experts' products


def _check_experts(what, x, w, dy=None) -> None:
    _check(what, x[0], w[0], None if dy is None else dy[0])
    if w.dim() != 3 or x.dim() != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"{what}: x{tuple(x.shape)} @ w{tuple(w.shape)}: "
                         "w must be (E, K, N) and x (E, M, K)")
    if dy is not None and dy.shape != (*x.shape[:2], w.shape[2]):
        raise ValueError(f"{what}: dy{tuple(dy.shape)} does not fit "
                         f"x{tuple(x.shape)} @ w{tuple(w.shape)}")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"{what}: {x.shape[0]} experts, at most "
                         f"{MAX_BATCH} a launch")


def expert_fwd_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.to(x.dtype)`` for each expert: ``_expert_ffn``'s einsum
    ``ecd,edf->ecf`` on the expert-major buckets."""
    return x @ w.to(x.dtype)


def expert_bwd_plain(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)``: the vjp of :func:`expert_fwd_plain` by autograd."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        wr = w.detach().requires_grad_(True)
        return torch.autograd.grad(expert_fwd_plain(xr, wr), (xr, wr), dy)


def expert_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel batched over experts (CUDA tensors only): x (E,
    M, K), w (E, K, N), each fp32 or bf16; ``x[e] @ w[e].to(x.dtype)``
    for every expert, (E, M, N) in x's dtype."""
    if not build.on_card(x):
        raise ValueError("expert_fwd runs on the card only")
    _check_experts("expert_fwd", x, w)
    E, M, K = x.shape
    N = w.shape[2]
    x, w = build.dense(x, "expert_fwd: x"), build.dense(w, "expert_fwd: w")
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    bf = x.dtype == torch.bfloat16
    tma = bf and K > 0 and _w_ok(w, N) and _tma((x, K, M * K))
    wbuf = _w_scratch(w, tma, M)
    err = lib.dense_fwd(build.ptr(x), K, build.ptr(w), build.ptr(y), None,
                        M, K, N, int(bf), int(w.dtype == torch.bfloat16), E,
                        M * K, K * N, M * N, int(tma), build.ptr(wbuf),
                        build.stream_ptr(x.device))
    build.check(lib, err, "expert_fwd")
    expert_fwd.launches += 1
    if bf and not tma:
        expert_fwd.mma_sync += 1
    return y


def expert_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
               need_dx: bool = True, need_dw: bool = True
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernels batched over experts (CUDA tensors only):
    ``(dx, dw)``, dx (E, M, K) in x's dtype, dw (E, K, N) in w's, each
    expert's the sum over its own M rows; either None where not needed."""
    if not build.on_card(x):
        raise ValueError("expert_bwd runs on the card only")
    _check_experts("expert_bwd", x, w, dy)
    E, M, K = x.shape
    N = w.shape[2]
    x_bf16, w_bf16 = int(x.dtype == torch.bfloat16), \
        int(w.dtype == torch.bfloat16)
    dy = build.dense(dy, "expert_bwd: dy")
    stream = build.stream_ptr(x.device)
    lib = _lib()
    dx = dw = None
    if need_dx:
        w = build.dense(w, "expert_bwd: w")
        dx = torch.empty((E, M, K), dtype=x.dtype, device=x.device)
        tma = x_bf16 and _w_ok(w, N) and _tma((dy, N, M * N))
        wbuf = _w_scratch(w, tma, M, K)
        err = lib.dense_dx(build.ptr(dy), N, build.ptr(w), build.ptr(dx), M,
                           K, N, x_bf16, w_bf16, E, M * N, K * N, M * K,
                           int(tma), build.ptr(wbuf), stream)
        build.check(lib, err, "expert_bwd (dx)")
        if x_bf16 and not tma:
            expert_bwd.mma_sync += 1
    if need_dw:
        x = build.dense(x, "expert_bwd: x")
        dw = torch.empty((E, K, N), dtype=w.dtype, device=x.device)
        tma = x_bf16 and M > 0 and _tma((x, K, M * K), (dy, N, M * N))
        slices, part = _dw_part(lib, M, K, N, E, x.device) if tma \
            else (1, None)
        err = lib.dense_dw(build.ptr(x), K, build.ptr(dy), N, build.ptr(dw),
                           M, K, N, x_bf16, w_bf16, E, M * K, M * N, K * N,
                           int(tma), slices, build.ptr(part), stream)
        build.check(lib, err, "expert_bwd (dw)")
        if x_bf16 and not tma:
            expert_bwd.mma_sync += 1
    expert_bwd.launches += 1
    return dx, dw


class _Experts(torch.autograd.Function):
    """The batched kernels as one autograd function (CUDA tensors): saves
    ``x`` and the stacked ``w`` as given (no bf16 copy of the weights)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return expert_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return expert_bwd(build.cotangent(dy), x, w,
                          need_dx=ctx.needs_input_grad[0],
                          need_dw=ctx.needs_input_grad[1])


def project_experts(x: torch.Tensor, w: torch.Tensor,
                    compute: torch.dtype) -> torch.Tensor:
    """``x[e] @ w[e].to(compute)`` for every expert, x (E, M, K) and w (E,
    K, N), differentiable in both: the batched kernels on the card (x in
    ``compute``), ``x @ w.to(compute)`` under autograd elsewhere."""
    if build.on_card(x):
        if x.dtype != compute:
            raise ValueError(f"experts: x is {x.dtype}, the compute dtype "
                             f"{compute}")
        return _Experts.apply(x, w)
    return x @ w.to(compute)


dense_fwd.launches = dense_fwd.mma_sync = 0
dense_bwd.launches = dense_bwd.mma_sync = 0
expert_fwd.launches = expert_fwd.mma_sync = 0
expert_bwd.launches = expert_bwd.mma_sync = 0
