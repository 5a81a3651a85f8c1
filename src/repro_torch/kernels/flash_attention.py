"""Kernel 4: blocked causal GQA flash attention, forward
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (wrapper
``repro/kernels/ops.py::flash_attention``): online fp32 softmax over kv
tiles, causal mask with queries at the end of the keys (offset
``Sk - Sq``), optional sliding window and ``softcap * tanh(s / softcap)``
logit cap, GQA through the kv head index, kv tiles outside the causal range
or the window skipped.  What bounds it on the H100 and how the kernel is
laid out is noted in the source.

:func:`flash_attention` takes the model layout ``q (B, Sq, H, D)``,
``k, v (B, Sk, G, D)`` and returns ``(B, Sq, H, D)``; for CPU tensors it is
the plain version :func:`flash_attention_plain`
(:func:`repro_torch.kernels.ref.flash_attention_ref` over the heads
flattened as ``ops.py`` flattens them).  :func:`flash_attention_fwd`
is the launch itself (CUDA only; bf16 takes the tensor-core kernels and
head dims 16, 32, 64, 128 and 256 only) and also returns ``lse`` (fp32,
``(B, G, H/G, Sq)``), which the TPU kernel does not produce and the
attention backward needs.  Launches count into ``flash_attention.launches``;
bf16 at head dims 64, 128 and 256 runs the Hopper form (``wgmma`` on
TMA-fed tiles), bf16 at 16 and 32 keeps the ``mma.sync`` form and counts
into ``flash_attention.mma_sync`` too.

:func:`flash_attention_bwd` is the backward (``csrc/flash_attention_bwd.cu``,
CUDA only, the same dtypes and head dims): ``(dq, dk, dv)`` from the
forward's ``out`` and ``lse`` and the output cotangent, as the plain
``models/attention.py::_chunked_bwd`` computes them; two kernel launches a
call, counted once into ``flash_attention_bwd.launches``.  bf16 at head dims
64, 128 and 256 runs the Hopper form (``wgmma`` on TMA-fed tiles); bf16 at
16 and 32 keeps the ``mma.sync`` form and counts into
``flash_attention_bwd.mma_sync`` too.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FNS = {torch.float32: "flash_attention_fwd_f32",
        torch.bfloat16: "flash_attention_fwd_bf16"}
MAX_HEAD_DIM = 256
BF16_HEAD_DIMS = (16, 32, 64, 128, 256)   # the tensor-core kernel's


_BWD_FNS = {torch.float32: "flash_attention_bwd_f32",
            torch.bfloat16: "flash_attention_bwd_bf16"}


def _lib():
    lib = build.load("flash_attention")
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [_P] * 5 + [_I] * 6 + [_F, _I, _I, _F, _P]
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    for name in _BWD_FNS.values():
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [_P] * 10 + [_I] * 6 + [_F, _I, _I, _F, _P]
    return lib


def _check(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} do not fit q (B, Sq, H, D), k/v (B, Sk, G, D)")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(
            f"flash_attention: q{tuple(q.shape)} and k{tuple(k.shape)} need "
            "the same batch and head dim, and H a multiple of G")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel (CUDA tensors only): ``(out, lse)``."""
    _check(q, k, v, window, softcap)
    if not build.on_card(q):
        raise ValueError("flash_attention_fwd runs on the card only")
    _check_launch("flash_attention", q, (("q", q), ("k", k), ("v", v)))
    return _launch(q, k, v, causal, window, softcap, scale)


def _check_launch(what, q, named) -> None:
    """What the kernels take: one dtype and device, contiguous, 16-byte
    aligned tensors; fp32 with any head dim up to ``MAX_HEAD_DIM`` or bf16
    with one of ``BF16_HEAD_DIMS``."""
    for name, t in named:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _FNS:
        raise ValueError(f"{what}: dtype {q.dtype} is not supported (one "
                         f"of {list(_FNS)})")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16 and q.shape[3] not in BF16_HEAD_DIMS:
        raise ValueError(f"{what}: bf16 head dim {q.shape[3]} is not one "
                         f"of {BF16_HEAD_DIMS}")
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel (CUDA tensors only; the plain version is
    ``models/attention.py::_chunked_bwd``): ``(dq, dk, dv)`` in the layouts
    and dtypes of ``q``, ``k``, ``v``.  ``out`` and ``lse`` are
    :func:`flash_attention_fwd`'s, ``dout`` the cotangent of ``out``."""
    _check(q, k, v, window, softcap)
    if not build.on_card(q):
        raise ValueError("flash_attention_bwd runs on the card only")
    B, Sq, H, _ = q.shape
    G = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out{tuple(out.shape)} and "
                         f"dout{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if (lse.shape != (B, G, H // G, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse{tuple(lse.shape)} "
                         f"{lse.dtype} must be contiguous fp32 "
                         f"{(B, G, H // G, Sq)} on {q.device}")
    _check_launch("flash_attention_bwd", q, (
        ("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)))
    return _launch_bwd(q, k, v, out, lse, dout, causal, window, softcap,
                       scale)


def _launch_bwd(q, k, v, out, lse, dout, causal, window, softcap, scale):
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    sc = (D ** -0.5) if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    err = getattr(lib, _BWD_FNS[q.dtype])(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        build.ptr(dout), build.ptr(lse), build.ptr(dvec), build.ptr(dq),
        build.ptr(dk), build.ptr(dv), B, Sq, Sk, H, G, D, float(sc),
        int(bool(causal)), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        build.stream_ptr(q.device))
    build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    if q.dtype == torch.bfloat16 and D < 64:
        flash_attention_bwd.mma_sync += 1
    return dq, dk, dv


def _launch(q, k, v, causal, window, softcap, scale):
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    sc = (D ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((B, G, H // G, Sq), dtype=torch.float32,
                      device=q.device)
    lib = _lib()
    err = getattr(lib, _FNS[q.dtype])(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        build.ptr(lse), B, Sq, Sk, H, G, D, float(sc), int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        build.stream_ptr(q.device))
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    if q.dtype == torch.bfloat16 and D < 64:
        flash_attention.mma_sync += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, G, D).  Returns (B, Sq, H, D)."""
    _check(q, k, v, window, softcap)
    if build.on_card(q):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)[0]
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, on any device: ``flash_attention_ref`` over the
    heads flattened as ``ops.py`` flattens them, K/V repeated per group."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Sq, D)
    kf = k.repeat_interleave(H // G, dim=2).permute(0, 2, 1, 3).reshape(
        B * H, Sk, D)
    vf = v.repeat_interleave(H // G, dim=2).permute(0, 2, 1, 3).reshape(
        B * H, Sk, D)
    of = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    return of.reshape(B, H, Sq, D).permute(0, 2, 1, 3)


flash_attention.launches = flash_attention.mma_sync = 0
flash_attention_bwd.launches = flash_attention_bwd.mma_sync = 0
