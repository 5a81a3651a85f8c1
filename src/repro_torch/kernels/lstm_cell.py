"""Kernel 1: the fused LSTM cell (``csrc/lstm_cell.cu``).

Replaces ``repro/kernels/lstm_cell.py::lstm_cell`` (wrapper
``repro/kernels/ops.py::lstm_cell``).  ``z = x@W[:Dx] + h@W[Dx:] + b``,
gates ``i, f, o, g``, ``c' = σ(f+1)c + σ(i)tanh(g)``, ``h' = σ(o)tanh(c')``,
all in fp32; fp32 or bf16 in, out in ``h.dtype``/``c.dtype``.  What bounds
it on the H100 and how the kernels are laid out is noted in the source.

:func:`lstm_cell` is the standalone kernel, one step: its plain version is
:func:`repro_torch.kernels.ref.lstm_cell_ref`, taken for CPU tensors only.
:func:`lstm_cell_autograd` is the same step under ``torch.autograd``: the
kernel forward, and as backward the vjp of the plain cell recomputed from
the saved inputs (the Pallas cell has no vjp either); the LSTM chain's
per-step body runs the cell through it.
:func:`lstm_cell_token_steps` runs a run of steps as one cooperative
launch with each block's columns of ``W`` resident on chip, the input rows
gathered from an embedding table: the fused advance's forward chunks, and
the fused reverse's recompute with the ``[x, h]`` rows and gate activations
its products need (CUDA only: its plain counterparts are the fused
kernels' plain versions).  Both count their launches into
``lstm_cell.launches`` and the cell steps those launches ran into
``lstm_cell.steps``.
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
    lib.lstm_cell_steps.restype = _I
    lib.lstm_cell_steps.argtypes = [_P] * 10 + [_I] * 5 + [_P, _P, _I, _P]
    lib.lstm_cell_max_k.restype = _I
    lib.lstm_cell_max_k.argtypes = []
    return lib


def _check_k(lib, Dx: int, Dh: int, what: str) -> None:
    """Both kernels keep a block's columns of W in shared memory."""
    max_k = lib.lstm_cell_max_k()
    if Dx + Dh > max_k:
        raise ValueError(
            f"{what}: Dx + Dh = {Dx + Dh} is above {max_k}, the widest whose "
            "columns of W (128 a block) fit this device's shared memory per "
            "block")


def _launch(fn_name: str, x, tok, h, c, w, b, h_out, c_out, xh_out,
            acts_out) -> None:
    lib = _lib()
    B, Dh = h.shape
    Dx = x.shape[1]
    _check_k(lib, Dx, Dh, "lstm_cell")
    err = getattr(lib, fn_name)(
        build.ptr(x), build.ptr(tok), build.ptr(h), build.ptr(c),
        build.ptr(w), build.ptr(b), build.ptr(h_out), build.ptr(c_out),
        build.ptr(xh_out), build.ptr(acts_out), B, Dx, Dh,
        build.stream_ptr(h.device))
    build.check(lib, err, "lstm_cell")
    lstm_cell.launches += 1
    lstm_cell.steps += 1


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
    if not build.on_card(x):
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
lstm_cell.steps = 0


class _Cell(torch.autograd.Function):
    """:func:`lstm_cell` forward; the backward recomputes the plain cell
    from ``(x, h, c, w, b)`` and takes its vjp."""

    @staticmethod
    def forward(ctx, x, h, c, w, b):
        ctx.save_for_backward(x, h, c, w, b)
        return lstm_cell(x, h, c, w, b)

    @staticmethod
    def backward(ctx, dh, dc):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = lstm_cell_ref(*inputs)
        return torch.autograd.grad(out, inputs, (dh, dc))


def lstm_cell_autograd(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lstm_cell`, differentiable: (h_new, c_new)."""
    return _Cell.apply(x, h, c, w, b)


def lstm_cell_token_steps(tok: Optional[torch.Tensor], emb: torch.Tensor,
                          hs: torch.Tensor, cs: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, *,
                          xh: Optional[torch.Tensor] = None,
                          acts: Optional[torch.Tensor] = None,
                          barrier: Optional[torch.Tensor] = None,
                          entry: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          = None, args: Optional[torch.Tensor] = None,
                          tok_lo: int = 0, steps: Optional[int] = None
                          ) -> None:
    """``L = len(tok)`` cell steps over the batch with ``x = emb[tok[t]]``
    (fp32, CUDA) in one launch: step ``t`` reads ``(hs[t], cs[t])`` and
    writes ``(hs[t+1], cs[t+1])`` and, when given, ``xh[t] = [x, h]`` and
    ``acts[t]`` (σ(i), σ(f+1), σ(o), tanh(g)).  ``tok (L, B)`` int32;
    ``hs, cs (>= L+1, B, Dh)``, ``xh (>= L, B, Dx+Dh)``, ``acts (>= L, B,
    4Dh)`` contiguous fp32 on the card; ``entry``: ``(h, c)``, each ``(B,
    Dh)``, read by step 0 in place of ``(hs[0], cs[0])`` (which are then
    not read); ``barrier``: int32 device scratch for the barriers,
    ``ceil(B / 16)`` counters (allocated when not given).

    A captured segment passes ``tok=None`` and its argument block ``args``
    (``ARG_WORDS`` int64 on the card, ``csrc/lstm_step.cuh``): the kernel
    reads the ids of its ``steps`` steps at launch, rows ``tok_lo ..`` of
    the segment's (a graph bakes in every pointer it was captured
    with)."""
    dev = (tok if tok is not None else args).device
    if dev.type != "cuda":
        raise ValueError("lstm_cell_token_steps runs on the card only")
    _token_steps(tok, emb, hs, cs, w, b, xh, acts, barrier, entry,
                 args=args, tok_lo=tok_lo, steps=steps)


def _token_steps(tok, emb, hs, cs, w, b, xh, acts, barrier=None, entry=None,
                 *, blocks_y: int = 0, args=None, tok_lo: int = 0,
                 steps: Optional[int] = None) -> None:
    """The launch behind :func:`lstm_cell_token_steps`; ``blocks_y`` > 0
    forces the grid's row-tile blocks (0: as many as can be resident)."""
    if (tok is None) == (args is None):
        raise ValueError("lstm_cell_token_steps: give tok or args")
    if tok is not None:
        L, B = tok.shape
        dev = tok.device
    else:
        L, B, dev = int(steps), hs.shape[1], args.device
    Dx, Dh = emb.shape[1], hs.shape[-1]
    f32 = torch.float32
    h_in, c_in = entry if entry is not None else (None, None)
    _check_cuda(f32, dev, emb=emb, hs=hs, cs=cs, w=w, b=b, xh=xh,
                acts=acts, h_entry=h_in, c_entry=c_in)
    _check_cuda(torch.int32, dev, tok=tok, barrier=barrier)
    _check_cuda(torch.int64, dev, args=args)
    if hs.shape[0] < L + 1 or hs.shape[1:] != (B, Dh) \
            or cs.shape != hs.shape or w.shape != (Dx + Dh, 4 * Dh) \
            or (entry is not None and (h_in.shape != (B, Dh)
                                       or c_in.shape != (B, Dh))) \
            or (xh is not None and (xh.shape[0] < L
                                    or xh.shape[1:] != (B, Dx + Dh))) \
            or (acts is not None and (acts.shape[0] < L
                                      or acts.shape[1:] != (B, 4 * Dh))):
        raise ValueError("lstm_cell_token_steps: operand shapes do not fit "
                         f"{L} steps of a ({B}, {Dh}) state")
    lib = _lib()
    _check_k(lib, Dx, Dh, "lstm_cell_token_steps")
    counters = max(-(-B // 16), int(blocks_y))
    if barrier is None:
        barrier = torch.empty((counters,), dtype=torch.int32, device=dev)
    if barrier.numel() < counters:
        raise ValueError(f"lstm_cell_token_steps: barrier has "
                         f"{barrier.numel()} counters, {counters} needed")
    ptr = build.ptr
    err = lib.lstm_cell_steps(
        ptr(emb), ptr(tok), ptr(hs), ptr(cs), ptr(w), ptr(b), ptr(xh),
        ptr(acts), ptr(h_in), ptr(c_in), L, B, Dx, Dh, int(blocks_y),
        ptr(barrier), ptr(args), int(tok_lo), build.stream_ptr(dev))
    build.check(lib, err, "lstm_cell_token_steps")
    lstm_cell.launches += 1
    lstm_cell.steps += L
