"""Kernel 1: the fused LSTM cell (``csrc/lstm_cell.cu``).

Replaces ``repro/kernels/lstm_cell.py::lstm_cell`` (wrapper
``repro/kernels/ops.py::lstm_cell``).  ``z = x@W[:Dx] + h@W[Dx:] + b``,
gates ``i, f, o, g``, ``c' = σ(f+1)c + σ(i)tanh(g)``, ``h' = σ(o)tanh(c')``,
all in fp32; fp32 or bf16 in, out in ``h.dtype``/``c.dtype``.  What bounds
it on the H100 and how the kernel is laid out is noted in the source.

:func:`lstm_cell` is the standalone kernel: its plain version is
:func:`repro_torch.kernels.ref.lstm_cell_ref`, taken for CPU tensors only.
:func:`lstm_cell_tokens` is the same kernel with the input rows gathered
from an embedding table, writing the ``[x, h]`` rows and gate activations
the fused reverse needs (CUDA only: its plain counterpart is the fused
reverse's plain version).  Both count into ``lstm_cell.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lstm_cell_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: "lstm_cell_f32", torch.bfloat16: "lstm_cell_bf16"}


def _lib():
    lib = build.load("lstm_cell")
    for name in _DTYPES.values():
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [_P] * 10 + [_I, _I, _I, _P]
    return lib


def _launch(fn_name: str, x, tok, h, c, w, b, h_out, c_out, xh_out,
            acts_out) -> None:
    lib = _lib()
    B, Dh = h.shape
    Dx = x.shape[1]
    err = getattr(lib, fn_name)(
        build.ptr(x), build.ptr(tok), build.ptr(h), build.ptr(c),
        build.ptr(w), build.ptr(b), build.ptr(h_out), build.ptr(c_out),
        build.ptr(xh_out), build.ptr(acts_out), B, Dx, Dh,
        build.stream_ptr(h.device))
    build.check(lib, err, "lstm_cell")
    lstm_cell.launches += 1


def _check_cuda(dtype, device, **tensors) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"lstm_cell: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"lstm_cell: {name} is {t.dtype}, "
                             f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} must be contiguous")


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, Dx); h, c: (B, Dh); w: (Dx+Dh, 4Dh); b: (4Dh,).
    Returns (h_new, c_new)."""
    B, Dx = x.shape
    Dh = h.shape[-1]
    if h.shape != (B, Dh) or c.shape != (B, Dh) \
            or w.shape != (Dx + Dh, 4 * Dh) or b.shape != (4 * Dh,):
        raise ValueError(
            f"lstm_cell: shapes x{tuple(x.shape)} h{tuple(h.shape)} "
            f"c{tuple(c.shape)} w{tuple(w.shape)} b{tuple(b.shape)} do not "
            "fit x (B, Dx), h/c (B, Dh), w (Dx+Dh, 4Dh), b (4Dh,)")
    if not x.is_cuda:
        # plain version: fp32 math, outputs in the state dtypes (as the
        # kernel does)
        f32 = torch.float32
        hn, cn = lstm_cell_ref(x.to(f32), h.to(f32), c.to(f32), w.to(f32),
                               b.to(f32))
        return hn.to(h.dtype), cn.to(c.dtype)
    if x.dtype not in _DTYPES:
        raise ValueError(f"lstm_cell: dtype {x.dtype} is not supported "
                         f"(one of {list(_DTYPES)})")
    _check_cuda(x.dtype, x.device, x=x, h=h, c=c, w=w, b=b)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    _launch(_DTYPES[x.dtype], x, None, h, c, w, b, h_out, c_out, None, None)
    return h_out, c_out


lstm_cell.launches = 0


def lstm_cell_tokens(tok: torch.Tensor, emb: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     h_out: torch.Tensor, c_out: torch.Tensor,
                     xh_out: Optional[torch.Tensor] = None,
                     acts_out: Optional[torch.Tensor] = None) -> None:
    """One cell step over the batch with ``x = emb[tok]`` (fp32, CUDA).
    Writes ``h_out``/``c_out`` and, when given, ``xh_out (B, Dx+Dh)`` and
    ``acts_out (B, 4Dh)`` (σ(i), σ(f+1), σ(o), tanh(g))."""
    if not tok.is_cuda:
        raise ValueError("lstm_cell_tokens runs on the card only")
    f32 = torch.float32
    _check_cuda(f32, tok.device, emb=emb, h=h, c=c, w=w, b=b, h_out=h_out,
                c_out=c_out, xh_out=xh_out, acts_out=acts_out)
    _check_cuda(torch.int32, tok.device, tok=tok)
    _launch("lstm_cell_f32", emb, tok, h, c, w, b, h_out, c_out, xh_out,
            acts_out)
