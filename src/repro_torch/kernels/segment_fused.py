"""Kernels 2 and 3: the fused segment kernels of ``runner="fused"``
(``csrc/segment_fused.cu``; the JAX package's ``runner="pallas"``).

* :func:`fused_advance_segment` replaces
  ``repro/kernels/segment_pallas.py::fused_advance_segment``: one launch
  advances the carry over a whole segment, and every chunk-entry carry is
  written by the kernel straight into page-locked host memory while the
  segment computes.  ``boundaries[0]`` is the segment-entry state the
  executor hands to Level 2, fenced by the returned CUDA event.
* :func:`fused_reverse_segment` replaces
  ``segment_pallas.py::fused_reverse_segment``: Echo-style recompute — phase
  A recomputes the chunk-entry boundaries from the Level-2 boundary, then the
  chunks are walked in reverse, each one's states recomputed into scratch
  (kernel 1, ``lstm_cell_tokens``) and transposed step by step, with the
  parameter gradients reduced in a fixed order.

The JAX kernels trace any chain body; the CUDA kernels are written for the
LSTM chain step only, which ``repro_torch.models.lstm`` registers here.  On
CUDA tensors an unregistered body raises ``ValueError``; on CPU tensors each
wrapper runs its plain version, which works for any body: the chunk layouts
of the JAX kernels (a length-1 forward tail merges into the previous chunk;
the reverse folds full chunks from zero in descending order and adds a
short tail chunk once at the end) with plain PyTorch steps and autograd.
What bounds each kernel on the H100, and what its design does about it, is
noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import build

SUPPORTED_BODIES = ("lstm",)
_BODIES: Dict[Any, str] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int


def register_body(body, kind: str) -> None:
    """Declare that ``body`` is the chain step the CUDA kernels of ``kind``
    implement."""
    if kind not in SUPPORTED_BODIES:
        raise ValueError(f"no fused kernels for body kind {kind!r}; "
                         f"supported: {SUPPORTED_BODIES}")
    _BODIES[body] = kind


def body_kind(body) -> str:
    """The registered kind of ``body``; raises ``ValueError`` for a body the
    CUDA kernels do not implement (there is no fallback on the card)."""
    kind = _BODIES.get(body)
    if kind is None:
        raise ValueError(
            f"runner='fused' on CUDA runs hand-written kernels for the chain "
            f"bodies {SUPPORTED_BODIES} only (registered with "
            f"segment_fused.register_body); got {body!r} — use "
            "runner='compiled' for other chains")
    return kind


def check_token_range(body, params, xs) -> None:
    """Host-side check, once per gradient call, of the ids the CUDA kernels
    index with: an out-of-range token or target would read outside the
    embedding or the logits.  (The wrappers themselves do not synchronise
    per segment to check; the plain versions index with PyTorch, which
    checks.)"""
    if _on_cpu(xs) or body_kind(body) != "lstm":
        return
    tok, tgt = xs
    if tok.numel() == 0:
        return
    lo_t, hi_t, lo_g, hi_g = torch.stack(
        [tok.min(), tok.max(), tgt.min(), tgt.max()]).tolist()
    V, V_out = params["emb"].shape[0], params["w_out"].shape[1]
    if lo_t < 0 or hi_t >= V or lo_g < 0 or hi_g >= V_out:
        raise ValueError(
            f"token ids must lie in [0, {V}) and targets in [0, {V_out}); "
            f"got tokens in [{lo_t}, {hi_t}], targets in [{lo_g}, {hi_g}]")


def forward_bounds(T: int, chunk: int) -> List[int]:
    """Chunk starts of the forward kernel plus ``T``: ``[0, chunk, ...,
    T]`` with a length-1 tail merged into the previous chunk (the JAX
    kernel's layout, ``segment_pallas.py:150-152``)."""
    chunk = min(int(chunk), T)
    bounds = list(range(0, T, chunk)) + [T]
    if len(bounds) > 2 and bounds[-1] - bounds[-2] == 1:
        del bounds[-2]
    return bounds


def reverse_layout(T: int, chunk: int) -> Tuple[int, int, int]:
    """``(chunk, num_chunks, tail_length)`` of the reverse kernel."""
    chunk = min(int(chunk), T)
    nc = -(-T // chunk)
    return chunk, nc, T - (nc - 1) * chunk


class FusedAdvance(NamedTuple):
    carry: Any        # the carry after the segment
    boundaries: Any   # the carry's structure, each leaf stacked (nc, ...)
    ready: Any        # CUDA event after which the boundaries are final
    #                   (None: they already are)


def _slice(xs, lo, hi):
    return pytree.tree_map(lambda leaf: leaf[lo:hi], xs)


def _on_cpu(tree) -> bool:
    return not any(t.is_cuda for t in pytree.tree_leaves(tree)
                   if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# plain versions (CPU tensors, any body)
# --------------------------------------------------------------------------


def advance_plain(body, params, carry, xs_seg, batch, *,
                  chunk: int) -> FusedAdvance:
    """The plain version of kernel 2: the carry over the segment plus every
    chunk-entry carry, stacked."""
    T = pytree.tree_leaves(xs_seg)[0].shape[0]
    bounds = forward_bounds(T, chunk)
    snaps = []
    with torch.no_grad():
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            snaps.append(pytree.tree_leaves(carry))
            for k in range(lo, hi):
                x = pytree.tree_map(lambda leaf: leaf[k], xs_seg)
                carry = body(params, carry, x, batch)
    spec = pytree.tree_structure(carry)
    stacked = [torch.stack([s[i] for s in snaps])
               for i in range(len(snaps[0]))]
    return FusedAdvance(carry, pytree.tree_unflatten(stacked, spec), None)


def reverse_plain(body, xs_mask, params, carry_b, xs_seg, batch, dcarry, *,
                  chunk: int):
    """The plain version of kernel 3: ``(dcarry_at_begin, dparams, dxd)``
    with the JAX kernel's chunking and fold order."""
    from repro_torch.api.chain import steps_vjp

    T = pytree.tree_leaves(xs_seg)[0].shape[0]
    chunk, nc, rem = reverse_layout(T, chunk)
    entries = [carry_b]
    with torch.no_grad():   # phase A: the chunk-entry boundaries
        c = carry_b
        for kk in range(nc - 1):
            for k in range(kk * chunk, (kk + 1) * chunk):
                x = pytree.tree_map(lambda leaf: leaf[k], xs_seg)
                c = body(params, c, x, batch)
            entries.append(c)
    gacc = pytree.tree_map(torch.zeros_like, params)
    dp_tail = None
    dc = dcarry
    dxd_chunks: Dict[int, list] = {}
    for kk in range(nc - 1, -1, -1):
        lo, hi = kk * chunk, min((kk + 1) * chunk, T)
        dp, dc, dxd_chunks[kk] = steps_vjp(
            body, params, entries[kk], _slice(xs_seg, lo, hi), batch,
            xs_mask, dc)
        if kk == nc - 1 and rem != chunk:
            dp_tail = dp   # short tail: added once at the end
        else:
            gacc = pytree.tree_map(torch.add, gacc, dp)
    if dp_tail is not None:
        gacc = pytree.tree_map(torch.add, gacc, dp_tail)
    n_diff = len(dxd_chunks[0])
    dxd = [torch.cat([dxd_chunks[kk][i] for kk in range(nc)])
           for i in range(n_diff)]
    return dc, gacc, dxd


# --------------------------------------------------------------------------
# CUDA: the LSTM chain step
# --------------------------------------------------------------------------


def _seg_lib():
    lib = build.load("segment_fused")
    if not getattr(lib, "_repro_typed", False):
        lib.segment_fused_rows_per_block.restype = _I
        lib.fused_advance_lstm.restype = _I
        lib.fused_advance_lstm.argtypes = (
            [_P] * 5 + [_I] * 3 + [_P] * 13 + [_I] * 4 + [_P])
        lib.chunk_backward_lstm.restype = _I
        lib.chunk_backward_lstm.argtypes = (
            [_P] * 5 + [_I] * 3 + [_P] * 10 + [_I] * 2 + [_P])
        lib.grad_gemm.restype = _I
        lib.grad_gemm.argtypes = [_P, _I, _P, _I, _I, _I, _I, _P, _I, _P]
        lib.embed_grad.restype = _I
        lib.embed_grad.argtypes = [_P, _P, _I, _I, _I, _P, _I, _P]
        lib.add_inplace.restype = _I
        lib.add_inplace.argtypes = [_P, _P, ctypes.c_long, _P]
        lib._repro_typed = True
    return lib


_LSTM_KEYS = ("emb", "w", "b", "w_out", "b_out")


def _lstm_operands(params, carry, xs_seg):
    """Validate and unpack the LSTM chain's operands for the kernels."""
    missing = [k for k in _LSTM_KEYS if k not in params]
    if missing:
        raise ValueError(f"fused LSTM kernels need params {_LSTM_KEYS}; "
                         f"missing {missing}")
    p = [params[k] for k in _LSTM_KEYS]
    h, c, acc = carry
    tok, tgt = xs_seg
    dev = h.device
    for name, t in zip(_LSTM_KEYS + ("h", "c", "acc"), p + [h, c, acc]):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"fused LSTM kernels: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    V, Dx = p[0].shape
    B, Dh = h.shape
    if p[1].shape != (Dx + Dh, 4 * Dh) or c.shape != (B, Dh) \
            or acc.shape != () or tok.shape != tgt.shape \
            or tok.shape[1:] != (B,) or p[4].shape != (V,) \
            or p[3].shape != (Dh, V) or p[2].shape != (4 * Dh,):
        raise ValueError("fused LSTM kernels: operand shapes do not fit "
                         "the LSTM chain")
    tok = tok.to(device=dev, dtype=torch.int32).contiguous()
    tgt = tgt.to(device=dev, dtype=torch.int32).contiguous()
    return p, (h, c, acc), (tok, tgt), (V, Dx, Dh, B)


def _advance_lstm_cuda(params, carry, xs_seg, chunk: int) -> FusedAdvance:
    lib = _seg_lib()
    p, (h0, c0, acc0), (tok, tgt), (V, Dx, Dh, B) = _lstm_operands(
        params, carry, xs_seg)
    T = tok.shape[0]
    bounds = forward_bounds(T, chunk)
    nc = len(bounds) - 1
    chunk = min(int(chunk), T)
    f32, dev = torch.float32, h0.device
    # the Level-2 copies: page-locked, written by the kernel through UVA
    bnd = (torch.empty((nc, B, Dh), dtype=f32, pin_memory=True),
           torch.empty((nc, B, Dh), dtype=f32, pin_memory=True),
           torch.empty((nc,), dtype=f32, pin_memory=True))
    out = (torch.empty_like(h0), torch.empty_like(c0),
           torch.empty((), dtype=f32, device=dev))
    nblk = -(-B // lib.segment_fused_rows_per_block())
    nll_part = torch.empty((T, nblk), dtype=f32, device=dev)
    msum = torch.empty((T,), dtype=f32, device=dev)
    ptr = build.ptr
    err = lib.fused_advance_lstm(
        *[ptr(t) for t in p], V, Dx, Dh, ptr(tok), ptr(tgt), ptr(h0),
        ptr(c0), ptr(acc0), *[ptr(t) for t in out], *[ptr(t) for t in bnd],
        ptr(nll_part), ptr(msum), T, B, chunk, nc, build.stream_ptr(dev))
    build.check(lib, err, "fused_advance_segment")
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    fused_advance_segment.launches += 1
    return FusedAdvance(out, bnd, ready)


def _reverse_lstm_cuda(params, carry_b, xs_seg, dcarry, chunk: int):
    from repro_torch.kernels.lstm_cell import lstm_cell_tokens

    lib = _seg_lib()
    p, (h_b, c_b, _), (tok, tgt), (V, Dx, Dh, B) = _lstm_operands(
        params, carry_b, xs_seg)
    emb, w, b, w_out, b_out = p
    dh_in, dc_in, dacc = dcarry
    T = tok.shape[0]
    chunk, nc, rem = reverse_layout(T, chunk)
    f32, dev = torch.float32, h_b.device
    K, N4 = Dx + Dh, 4 * Dh
    ptr, stream = build.ptr, build.stream_ptr(dev)

    # phase A: every chunk-entry (h, c), recomputed from the Level-2 boundary
    ent_h = torch.empty((nc, B, Dh), dtype=f32, device=dev)
    ent_c = torch.empty_like(ent_h)
    ent_h[0].copy_(h_b)
    ent_c[0].copy_(c_b)
    tmp_h = torch.empty((2, B, Dh), dtype=f32, device=dev)
    tmp_c = torch.empty_like(tmp_h)
    for kk in range(1, nc):
        src_h, src_c = ent_h[kk - 1], ent_c[kk - 1]
        for t in range(chunk):
            last = t == chunk - 1
            dst_h = ent_h[kk] if last else tmp_h[t % 2]
            dst_c = ent_c[kk] if last else tmp_c[t % 2]
            lstm_cell_tokens(tok[(kk - 1) * chunk + t], emb, src_h, src_c, w,
                             b, h_out=dst_h, c_out=dst_c)
            src_h, src_c = dst_h, dst_c

    # gradients in one flat buffer: [emb | w ; b | w_out ; b_out], so each
    # fixed-order reduction writes its (rows + bias row) block in place
    sizes = [V * Dx, K * N4, N4, Dh * V, V]
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    total = sum(sizes)
    gacc = torch.zeros((total,), dtype=f32, device=dev)
    tail = torch.empty_like(gacc) if rem != chunk else None

    hs = torch.empty((chunk + 1, B, Dh), dtype=f32, device=dev)
    cs = torch.empty_like(hs)
    acts = torch.empty((chunk, B, N4), dtype=f32, device=dev)
    xh = torch.empty((chunk, B, K), dtype=f32, device=dev)
    dz = torch.empty((chunk, B, N4), dtype=f32, device=dev)
    dl = torch.empty((chunk, B, V), dtype=f32, device=dev)
    dx = torch.empty((chunk, B, Dx), dtype=f32, device=dev)
    dh = dh_in.to(f32).contiguous().clone()
    dc = dc_in.to(f32).contiguous().clone()
    dacc = dacc.to(dtype=f32, device=dev).contiguous()
    for kk in range(nc - 1, -1, -1):
        lo, hi = kk * chunk, min((kk + 1) * chunk, T)
        L, M = hi - lo, (hi - lo) * B
        hs[0].copy_(ent_h[kk])
        cs[0].copy_(ent_c[kk])
        for t in range(L):   # the chunk's states, into scratch
            lstm_cell_tokens(tok[lo + t], emb, hs[t], cs[t], w, b,
                             h_out=hs[t + 1], c_out=cs[t + 1],
                             xh_out=xh[t], acts_out=acts[t])
        err = lib.chunk_backward_lstm(
            *[ptr(t) for t in p], V, Dx, Dh, ptr(tgt[lo]), ptr(hs), ptr(cs),
            ptr(acts), ptr(dacc), ptr(dh), ptr(dc), ptr(dz), ptr(dl),
            ptr(dx), L, B, stream)
        build.check(lib, err, "fused_reverse_segment (chunk backward)")
        short_tail = kk == nc - 1 and rem != chunk
        dst, acc = (tail, 0) if short_tail else (gacc, 1)
        base = dst.data_ptr()
        fbytes = dst.element_size()
        err = lib.grad_gemm(ptr(xh), K, ptr(dz), N4, M, K, N4,
                            _P(base + offs[1] * fbytes), acc, stream)
        build.check(lib, err, "fused_reverse_segment (dW)")
        err = lib.grad_gemm(ptr(hs[1]), Dh, ptr(dl), V, M, Dh, V,
                            _P(base + offs[3] * fbytes), acc, stream)
        build.check(lib, err, "fused_reverse_segment (dw_out)")
        err = lib.embed_grad(ptr(tok[lo]), ptr(dx), M, V, Dx,
                             _P(base + offs[0] * fbytes), acc, stream)
        build.check(lib, err, "fused_reverse_segment (demb)")
    if tail is not None:
        err = lib.add_inplace(ptr(gacc), ptr(tail), total, stream)
        build.check(lib, err, "fused_reverse_segment (tail fold)")
    shapes = [(V, Dx), (K, N4), (N4,), (Dh, V), (V,)]
    dparams = {k: gacc[o:o + n].view(s)
               for k, o, n, s in zip(_LSTM_KEYS, offs, sizes, shapes)}
    fused_reverse_segment.launches += 1
    return (dh, dc, dacc.clone()), dparams, []


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def fused_advance_segment(body, params, carry, xs_seg, batch, *,
                          chunk: int) -> FusedAdvance:
    """Advance the carry over one segment with the fused forward kernel.

    Returns ``FusedAdvance(carry_out, boundaries, ready)``: ``boundaries``
    mirrors the carry with a leading ``num_chunks`` axis of chunk-entry
    states (on the card: page-locked host tensors written by the kernel,
    final once ``ready`` has completed); ``boundaries[...][0]`` is the
    segment-entry state the executor stores to Level 2."""
    if _on_cpu(carry):
        return advance_plain(body, params, carry, xs_seg, batch, chunk=chunk)
    body_kind(body)
    return _advance_lstm_cuda(params, carry, xs_seg, chunk)


fused_advance_segment.launches = 0


def fused_reverse_segment(body, xs_mask, params, carry_b, xs_seg, batch,
                          dcarry, *, chunk: int):
    """Reverse one segment with Echo-style fused recompute.

    Returns ``(dcarry_at_begin, dparams_for_segment, dxs_diff_leaves)``;
    the caller folds ``dparams_for_segment`` into its gradient accumulator
    (``gacc + dp``).  The LSTM chain's per-step inputs are token ids, so on
    the card ``dxs_diff_leaves`` is empty."""
    if _on_cpu(carry_b):
        return reverse_plain(body, xs_mask, params, carry_b, xs_seg, batch,
                             dcarry, chunk=chunk)
    body_kind(body)
    return _reverse_lstm_cuda(params, carry_b, xs_seg, dcarry, chunk)


fused_reverse_segment.launches = 0
