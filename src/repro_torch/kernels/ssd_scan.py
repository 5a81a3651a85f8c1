"""Kernel 5: the Mamba-2 chunked SSD scan, forward (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (wrapper
``repro/kernels/ops.py::ssd_scan``): per chunk the intra-chunk masked
``C Bᵀ`` decay form, the inter-chunk term from the carried ``(P, N)`` fp32
state, and the state update; returns ``y`` and the final state.  On the
card one call runs four passes (every chunk's decay, every chunk's own
state contribution, the state passed over the chunks, every chunk's
output), bf16 on the tensor cores; what bounds it on the H100 and how it
is laid out is noted in the source.

:func:`ssd_scan` takes the head-structured layout of ``ops.ssd_scan`` —
``x (B, T, H, P)``, ``dt (B, T, H)``, ``A (H,)``, ``b, c (B, T, G, N)`` —
and an optional entry state ``h0 (B, H, P, N)``; it returns
``(y (B, T, H, P) in x.dtype, h (B, H, P, N) fp32)``.  Where
``build.on_card`` is false (CPU and meta tensors) it is the plain version
:func:`ssd_scan_plain` (:func:`repro_torch.kernels.ref.ssd_scan_ref` over
the heads flattened as ``ops.py`` flattens them); for CUDA tensors it
launches the kernel or raises.  Launches count into ``ssd_scan.launches``,
one a call (its four passes).

:func:`ssd_scan_bwd` is its vjp (``csrc/ssd_scan_bwd.cu``, nine passes
counted as one launch into ``ssd_scan_bwd.launches``): the arithmetic of
``jax.vjp`` of ``repro/models/ssm.py::ssd_chunked`` that the TPU segment
kernels trace (``segment_pallas.py:395-409``), on the card only; its plain
version :func:`ssd_scan_bwd_plain` is autograd over
``repro_torch.models.ssm.ssd_chunked_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_FNS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def _lib():
    lib = build.load("ssd_scan")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    lib.ssd_scan_scratch.restype = ctypes.c_long
    lib.ssd_scan_scratch.argtypes = [_I] * 7
    return lib


def _bwd_lib():
    lib = build.load("ssd_scan_bwd")
    lib.ssd_scan_bwd.restype = _I
    lib.ssd_scan_bwd.argtypes = [_P] * 15 + [_I] * 8 + [_P]
    lib.ssd_scan_bwd_scratch.restype = ctypes.c_long
    lib.ssd_scan_bwd_scratch.argtypes = [_I] * 7
    return lib


def bf16_limits() -> Tuple[int, int, int]:
    """The largest chunk, head dim P and state size N the bf16 kernels
    take (their tiles are padded to multiples of 16 up to these)."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(3)]
    lib.ssd_scan_bf16_limits(*[ctypes.byref(v) for v in vals])
    return tuple(v.value for v in vals)


def ssd_scan_plain(x, dt, A, b, c, h0=None):
    """The plain version, on any device: ``ssd_scan_ref`` over the heads
    flattened as ``ops.py`` flattens them."""
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    la = dt * A[None, None, :]
    bh = b.repeat_interleave(rep, dim=2)
    ch = c.repeat_interleave(rep, dim=2)
    y, h = ssd_scan_ref(
        x.permute(0, 2, 1, 3).reshape(B * H, T, P),
        la.permute(0, 2, 1).reshape(B * H, T),
        bh.permute(0, 2, 1, 3).reshape(B * H, T, N),
        ch.permute(0, 2, 1, 3).reshape(B * H, T, N),
        dt.permute(0, 2, 1).reshape(B * H, T),
        None if h0 is None else h0.reshape(B * H, P, N))
    return (y.reshape(B, H, T, P).permute(0, 2, 1, 3),
            h.reshape(B, H, P, N))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (shapes in the module docstring).  ``chunk`` is
    the kernel's chunk length; a shorter last chunk takes the remainder."""
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(
            f"ssd_scan: x{tuple(x.shape)} b{tuple(b.shape)} "
            f"c{tuple(c.shape)} do not fit x (B, T, H, P), b/c (B, T, G, N)")
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (b.shape[:2] != (B, T) or dt.shape != (B, T, H) or A.shape != (H,)
            or H % G != 0 or chunk < 1):
        raise ValueError(
            f"ssd_scan: dt{tuple(dt.shape)} A{tuple(A.shape)} "
            f"b{tuple(b.shape)} chunk {chunk} do not fit x{tuple(x.shape)}")
    if h0 is not None and h0.shape != (B, H, P, N):
        raise ValueError(f"ssd_scan: h0{tuple(h0.shape)} is not "
                         f"{(B, H, P, N)}")
    if not build.on_card(x):
        return ssd_scan_plain(x, dt, A, b, c, h0)
    f32 = torch.float32
    want = {"x": (x, x.dtype), "b": (b, x.dtype), "c": (c, x.dtype),
            "dt": (dt, f32), "A": (A, f32), "h0": (h0, f32)}
    for name, (t, dtype) in want.items():
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype} on {t.device},"
                             f" expected {dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dtype not in _FNS:
        raise ValueError(f"ssd_scan: dtype {x.dtype} is not supported (one "
                         f"of {list(_FNS)})")
    if x.dtype == torch.bfloat16:
        lim = bf16_limits()
        if min(chunk, T) > lim[0] or P > lim[1] or N > lim[2]:
            raise ValueError(
                f"ssd_scan: the bf16 kernel takes chunk <= {lim[0]}, P <= "
                f"{lim[1]}, N <= {lim[2]}; got chunk {chunk}, P {P}, N {N}")
    return _launch(x, dt, A, b, c, h0, chunk)


def _launch(x, dt, A, b, c, h0, chunk):
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    # the passes' per-chunk decays and states
    scratch = torch.empty(
        (max(1, lib.ssd_scan_scratch(B, T, H, P, N, int(chunk),
                                     int(x.dtype == torch.bfloat16))),),
        dtype=torch.float32, device=x.device)
    err = getattr(lib, _FNS[x.dtype])(
        build.ptr(x), build.ptr(dt), build.ptr(A), build.ptr(b),
        build.ptr(c), build.ptr(h0), build.ptr(y), build.ptr(h),
        build.ptr(scratch), B, T, H, G, P, N, int(chunk),
        build.stream_ptr(x.device))
    build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


def ssd_scan_bwd_plain(x, dt, A, b, c, h0, dy, dh_final, *, chunk: int
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dx, ddt, dA, db, dc, dh0)`` (``dh0`` None without ``h0``): the
    vjp of ``ssd_chunked_plain`` for the cotangents ``dy`` of y and
    ``dh_final`` (None: zero) of the final state, by autograd over the
    plain chunked form recomputed in fp32."""
    from repro_torch.models.ssm import ssd_chunked_plain

    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in (x, dt, A, b, c, h0)]
        y, hf = ssd_chunked_plain(*ins[:5], chunk=chunk, h0=ins[5])
        outs, cots = [y], [dy]
        if dh_final is not None:
            outs.append(hf)
            cots.append(dh_final)
        grads = iter(torch.autograd.grad(
            outs, [t for t in ins if t is not None], cots))
    return tuple(None if t is None else next(grads) for t in ins)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, h0: Optional[torch.Tensor],
                 dy: torch.Tensor, dh_final: Optional[torch.Tensor], *,
                 chunk: int = 128) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward kernel (card only): ``(dx, ddt, dA, db, dc, dh0)`` for
    :func:`ssd_scan`'s inputs (shapes in the module docstring) and the
    cotangents ``dy`` (x's shape and dtype) and ``dh_final`` ((B, H, P, N)
    fp32, None: zero); each in its input's dtype, ``dh0`` None without
    ``h0``.  It recomputes the chunks' decays and entry states itself, so
    the forward saves only its inputs."""
    if not build.on_card(x):
        raise ValueError("ssd_scan_bwd runs on the card only")
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(
            f"ssd_scan_bwd: x{tuple(x.shape)} b{tuple(b.shape)} "
            f"c{tuple(c.shape)} do not fit x (B, T, H, P), b/c (B, T, G, N)")
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (b.shape[:2] != (B, T) or dt.shape != (B, T, H) or A.shape != (H,)
            or H % G != 0 or chunk < 1 or dy.shape != x.shape):
        raise ValueError(
            f"ssd_scan_bwd: dt{tuple(dt.shape)} A{tuple(A.shape)} "
            f"b{tuple(b.shape)} dy{tuple(dy.shape)} chunk {chunk} do not "
            f"fit x{tuple(x.shape)}")
    f32 = torch.float32
    want = {"x": (x, x.dtype), "b": (b, x.dtype), "c": (c, x.dtype),
            "dy": (dy, x.dtype), "dt": (dt, f32), "A": (A, f32),
            "h0": (h0, f32), "dh_final": (dh_final, f32)}
    for name, (t, dtype) in want.items():
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"ssd_scan_bwd: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd: {name} must be contiguous")
        if name in ("h0", "dh_final") and t.shape != (B, H, P, N):
            raise ValueError(f"ssd_scan_bwd: {name}{tuple(t.shape)} is not "
                             f"{(B, H, P, N)}")
    if x.dtype not in _FNS:
        raise ValueError(f"ssd_scan_bwd: dtype {x.dtype} is not supported "
                         f"(one of {list(_FNS)})")
    if x.dtype == torch.bfloat16:
        lim = bf16_limits()   # the forward's: the backward takes its inputs
        if min(chunk, T) > lim[0] or P > lim[1] or N > lim[2]:
            raise ValueError(
                f"ssd_scan_bwd: the bf16 kernels take chunk <= {lim[0]}, P "
                f"<= {lim[1]}, N <= {lim[2]}; got chunk {chunk}, P {P}, N "
                f"{N}")
    lib = _bwd_lib()
    scratch = torch.empty(
        (max(1, lib.ssd_scan_bwd_scratch(B, T, H, G, P, N, int(chunk))),),
        dtype=f32, device=x.device)
    dx, db, dc = (torch.empty_like(t) for t in (x, b, c))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dh0 = torch.empty((B, H, P, N), dtype=f32, device=x.device)
    err = lib.ssd_scan_bwd(
        build.ptr(x), build.ptr(dt), build.ptr(A), build.ptr(b),
        build.ptr(c), build.ptr(h0), build.ptr(dy), build.ptr(dh_final),
        build.ptr(dx), build.ptr(ddt), build.ptr(dA), build.ptr(db),
        build.ptr(dc), build.ptr(dh0), build.ptr(scratch), B, T, H, G, P, N,
        int(chunk), int(x.dtype == torch.bfloat16),
        build.stream_ptr(x.device))
    build.check(lib, err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, db, dc, (None if h0 is None else dh0)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
