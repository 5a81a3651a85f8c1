"""Mamba-2's causal depthwise convolution over the (x, B, C) channels with
its bias and SiLU, forward and backward (``csrc/causal_conv.cu``).

Replaces the arithmetic of ``repro/models/ssm.py:179-188`` and its vjp
inside the TPU kernels ``repro/kernels/segment_pallas.py``'s segments (a
mamba2 body traced into the ``pallas_call``).  :func:`conv_silu` is what
the model calls: on the card (``build.on_card``) an autograd function whose
forward and backward launch :func:`causal_conv` and :func:`causal_conv_bwd`
(or raise), elsewhere the plain version :func:`causal_conv_plain` (the JAX
package's operations one for one: the byte profile counts them on meta
tensors) under autograd, whose vjp is :func:`causal_conv_bwd_plain`.  Both
return the new carried window (the last ``K - 1`` rows of ``[window;
xbc]``) as a view where it can be one.  Launches count into
``causal_conv.launches`` and ``causal_conv_bwd.launches`` (the backward is
three kernel launches a call, counted once).

Shapes: ``xbc`` (B, T, C), ``w`` (K, C), ``bias`` (C,), ``window`` (B,
K - 1, C) or None (zeros), all of one dtype (the model's compute dtype).
``xbc`` may be a column slice of wider rows (read in place).  The kernels
also split their output by columns: :func:`causal_conv` with ``splits``
writes the column pieces into buffers of their own (mamba2's x, B and C,
which the SSD reads as they are), and :func:`causal_conv_bwd` reads its
cotangent as those pieces (the first plus a second addend ``g_add``, as
autograd would add them) and writes ``dxbc`` into a given view (its
columns of the input projection's cotangent buffer).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("causal_conv")
    lib.causal_conv_fwd.restype = _I
    lib.causal_conv_fwd.argtypes = [_P] * 7 + [_L] * 3 + [_I] * 6 + [
        _L, _I, _P]
    lib.causal_conv_bwd.restype = _I
    lib.causal_conv_bwd.argtypes = ([_P] * 7 + [_L] * 3 + [_I] * 2
                                    + [_P, _P, _L] + [_P] * 4 + [_I] * 4
                                    + [_L, _I, _P])
    lib.causal_conv_bwd_parts.restype = _I
    lib.causal_conv_bwd_parts.argtypes = [_L]
    lib.causal_conv_max_k.restype = _I
    lib.causal_conv_max_k.argtypes = []
    return lib


def causal_conv_plain(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      window: Optional[torch.Tensor], dtype=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(silu(conv + bias), new window)``, ``w`` and ``bias`` cast to
    ``dtype`` (default xbc's) a row at a time: the model's operations one
    for one (every product and partial sum rounded to that dtype)."""
    Bsz, T, C = xbc.shape
    K = w.shape[0]
    dtype = xbc.dtype if dtype is None else dtype
    win = (window if window is not None else
           torch.zeros((Bsz, K - 1, C), dtype=xbc.dtype, device=xbc.device))
    pad = torch.cat([win.to(xbc.dtype), xbc], dim=1)
    conv = sum(pad[:, i:i + T, :] * w[i].to(dtype)[None, None, :]
               for i in range(K)) + bias.to(dtype)
    return F.silu(conv), pad[:, T:, :]


def causal_conv_bwd_plain(g, xbc, w, bias, window):
    """``(dxbc, dw, dbias, dwindow)`` (``dwindow`` None without a window):
    the vjp of :func:`causal_conv_plain`'s output for the cotangent ``g``,
    by autograd over the plain forward recomputed."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in (xbc, w, bias, window)]
        out, _ = causal_conv_plain(*ins)
        wanted = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(None if t is None else next(grads) for t in ins)


def window_of(xbc, window, K):
    """The last K - 1 rows of ``[window; xbc]``: a view of ``xbc`` where
    it is at least that long."""
    T = xbc.shape[1]
    if T >= K - 1:
        return xbc[:, T - (K - 1):, :]
    win = (window if window is not None else
           torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                       dtype=xbc.dtype, device=xbc.device))
    return torch.cat([win.to(xbc.dtype), xbc], dim=1)[:, T:, :]


def _check(what, xbc, w, bias, window):
    if xbc.dim() != 3 or w.dim() != 2 or w.shape[1] != xbc.shape[2] \
            or bias.shape != (xbc.shape[2],):
        raise ValueError(f"{what}: xbc{tuple(xbc.shape)} w{tuple(w.shape)} "
                         f"bias{tuple(bias.shape)} do not fit xbc (B, T, C), "
                         "w (K, C), bias (C,)")
    Bsz, _, C = xbc.shape
    K = w.shape[0]
    if window is not None and window.shape != (Bsz, K - 1, C):
        raise ValueError(f"{what}: window{tuple(window.shape)} is not "
                         f"{(Bsz, K - 1, C)}")
    for name, t in (("xbc", xbc), ("w", w), ("bias", bias),
                    ("window", window)):
        if t is None:
            continue
        if t.device != xbc.device or t.dtype != xbc.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {xbc.dtype} on {xbc.device}")
    if xbc.dtype not in DTYPES:
        raise ValueError(f"{what}: dtype {xbc.dtype} is not one of "
                         f"{list(DTYPES)}")
    kmax = _lib().causal_conv_max_k()
    if not 1 <= K <= kmax:
        raise ValueError(f"{what}: the kernels take a width K <= {kmax}; got "
                         f"{K}")


def _pieces(what, ts: Sequence[torch.Tensor], Bsz: int, T: int, C: int,
            dtype) -> Tuple[list, list, int, int]:
    """The kernels' column pieces: pointers' tensors (three, None padded),
    their row strides and the piece boundaries ``c1``, ``c2``."""
    ts = list(ts)
    if not 1 <= len(ts) <= 3 or any(
            t.dim() != 3 or t.shape[:2] != (Bsz, T) or t.dtype != dtype
            for t in ts) or sum(t.shape[2] for t in ts) != C:
        raise ValueError(f"{what}: pieces "
                         f"{[(tuple(t.shape), t.dtype) for t in ts]} do not "
                         f"split ({Bsz}, {T}, {C}) {dtype} by columns")
    rows, lds = [], []
    for i, t in enumerate(ts):
        r, ld = build.rows(t, t.shape[2], f"{what}: piece {i}")
        rows.append(r)
        lds.append(ld)
    widths = [t.shape[2] for t in ts] + [0] * (3 - len(ts))
    c1 = widths[0]
    return (rows + [None] * (3 - len(ts)), lds + [0] * (3 - len(ts)), c1,
            c1 + widths[1])


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                window: Optional[torch.Tensor] = None,
                splits: Sequence[int] = ()) -> Tuple[torch.Tensor, ...]:
    """The forward kernel (card only): ``silu(conv + bias)`` (B, T, C), as
    one tensor, or with ``splits`` (column widths summing to C, up to
    three) as that many contiguous tensors, written by the kernel."""
    if not build.on_card(xbc):
        raise ValueError("causal_conv runs on the card only")
    _check("causal_conv", xbc, w, bias, window)
    Bsz, T, C = xbc.shape
    widths = list(splits) or [C]
    xr, sx = build.rows(xbc, C, "causal_conv: xbc")
    outs = [torch.empty((Bsz, T, c), dtype=xbc.dtype, device=xbc.device)
            for c in widths]
    ptrs, lds, c1, c2 = _pieces("causal_conv", outs, Bsz, T, C, xbc.dtype)
    lib = _lib()
    err = lib.causal_conv_fwd(
        build.ptr(xr), build.ptr(build.dense(window, "causal_conv: window")),
        build.ptr(build.dense(w, "causal_conv: w")),
        build.ptr(build.dense(bias, "causal_conv: bias")),
        *[build.ptr(p) for p in ptrs], *lds, c1, c2, Bsz, T, C, w.shape[0],
        sx, int(xbc.dtype == torch.bfloat16), build.stream_ptr(xbc.device))
    build.check(lib, err, "causal_conv")
    causal_conv.launches += 1
    return tuple(outs) if splits else outs[0]


def causal_conv_bwd(g, xbc: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor, window: Optional[torch.Tensor] = None,
                    *, g_add: Optional[torch.Tensor] = None,
                    dx_out: Optional[torch.Tensor] = None
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward kernel (card only): ``(dxbc, dw, dbias, dwindow)`` for
    the cotangent ``g`` of :func:`causal_conv`'s output (``dwindow`` None
    without a window), in the inputs' dtype.  ``g``: a tensor, or a tuple
    of its column pieces (as :func:`causal_conv`'s ``splits`` gives them);
    ``g_add``: a second cotangent of the first piece, added to it (rounded
    to its dtype) as autograd would; ``dx_out``: the (B, T, C) view (rows
    with one stride) that takes ``dxbc``, which is then returned."""
    if not build.on_card(xbc):
        raise ValueError("causal_conv_bwd runs on the card only")
    _check("causal_conv_bwd", xbc, w, bias, window)
    Bsz, T, C = xbc.shape
    K = w.shape[0]
    gs = list(g) if isinstance(g, (tuple, list)) else [g]
    gptrs, glds, c1, c2 = _pieces("causal_conv_bwd", gs, Bsz, T, C,
                                  xbc.dtype)
    if g_add is not None and (g_add.shape != gs[0].shape
                              or g_add.dtype != gs[0].dtype
                              or g_add.stride() != gs[0].stride()):
        raise ValueError(f"causal_conv_bwd: g_add{tuple(g_add.shape)} "
                         f"{g_add.dtype} is not laid out as the first "
                         f"piece {tuple(gs[0].shape)} {gs[0].dtype}")
    xr, sx = build.rows(xbc, C, "causal_conv_bwd: xbc")
    win = build.dense(window, "causal_conv_bwd: window")
    lib = _lib()
    part = torch.empty((lib.causal_conv_bwd_parts(Bsz * T), K + 1, C),
                       dtype=torch.float32, device=xbc.device)
    if dx_out is None:
        dx_out = torch.empty((Bsz, T, C), dtype=xbc.dtype,
                             device=xbc.device)
    elif dx_out.shape != (Bsz, T, C) or dx_out.dtype != xbc.dtype:
        raise ValueError(f"causal_conv_bwd: dx_out{tuple(dx_out.shape)} "
                         f"{dx_out.dtype} is not {(Bsz, T, C)} "
                         f"{xbc.dtype}")
    dxr, sdx = build.rows(dx_out, C, "causal_conv_bwd: dx_out")
    dwin = None if win is None else torch.empty_like(win)
    dw = torch.empty((K, C), dtype=w.dtype, device=xbc.device)
    db = torch.empty((C,), dtype=bias.dtype, device=xbc.device)
    err = lib.causal_conv_bwd(
        build.ptr(xr), build.ptr(win),
        build.ptr(build.dense(w, "causal_conv_bwd: w")),
        build.ptr(build.dense(bias, "causal_conv_bwd: bias")),
        *[build.ptr(p) for p in gptrs], *glds, c1, c2, build.ptr(g_add),
        build.ptr(dxr), sdx, build.ptr(dwin), build.ptr(dw), build.ptr(db),
        build.ptr(part), Bsz, T, C, K, sx, int(xbc.dtype == torch.bfloat16),
        build.stream_ptr(xbc.device))
    build.check(lib, err, "causal_conv_bwd")
    causal_conv_bwd.launches += 1
    return dx_out, dw, db, dwin


class _CausalConv(torch.autograd.Function):
    """The kernels as one autograd function (card tensors)."""

    @staticmethod
    def forward(ctx, xbc, w, bias, window):
        out = causal_conv(xbc, w, bias, window)
        ctx.save_for_backward(xbc, w, bias, window)
        return out

    @staticmethod
    def backward(ctx, g):
        return causal_conv_bwd(build.cotangent(g), *ctx.saved_tensors)


def conv_silu(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              window: Optional[torch.Tensor] = None, dtype=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(silu(causal depthwise conv of [window; xbc] + bias), new
    window)``, ``w`` and ``bias`` cast to ``dtype`` (default xbc's, which
    it must be on the card), differentiable in all four: the kernels on
    the card, autograd over the plain forward elsewhere."""
    if build.on_card(xbc):
        dtype = xbc.dtype if dtype is None else dtype
        win = None if window is None else window.to(xbc.dtype)
        return (_CausalConv.apply(xbc, w.to(dtype), bias.to(dtype), win),
                window_of(xbc, win, w.shape[0]))
    return causal_conv_plain(xbc, w, bias, window, dtype)


causal_conv.launches = 0
causal_conv_bwd.launches = 0
