"""Kernels 2 and 3: the fused segment kernels of ``runner="fused"``
(``csrc/segment_fused.cu``; the JAX package's ``runner="pallas"``).

* :func:`fused_advance_segment` replaces
  ``repro/kernels/segment_pallas.py::fused_advance_segment``: each forward
  chunk runs the recurrence alone on kernel 1's step loop
  (``lstm_cell_token_steps``: one cooperative launch per chunk), then the
  readout and the loss over all rows of the chunk at once, in a kernel that
  also writes the chunk-entry carry straight into page-locked host memory
  (each chunk entry its own allocation); one launch a segment carries the
  loss accumulator in step order.  ``entries[0]`` is the segment-entry
  state the executor hands to Level 2, fenced by the returned CUDA event.
* :func:`fused_reverse_segment` replaces
  ``segment_pallas.py::fused_reverse_segment``: Echo-style recompute — phase
  A recomputes the chunk-entry boundaries from the Level-2 boundary, then the
  chunks are walked in reverse, each one's states recomputed into scratch
  (kernel 1's step loop, ``lstm_cell_token_steps``: one launch per run of
  steps); the products that do not carry the
  recurrence (logits, dlogits, their pull-back through ``w_out``, ``dx``)
  run over all rows of the chunk at once, the walk carries only
  ``dh_t = dz_t W_h^T`` and the cell's vjp (one cooperative launch per
  chunk), and the parameter gradients are reduced in a fixed order.

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

import contextlib
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


def cell_work(T: int, chunk: int) -> Dict[str, Tuple[int, int]]:
    """Kernel 1's step-loop launches and cell steps on the card for one
    segment of ``T`` steps, by caller: ``{"advance": (launches, steps),
    "reverse": (launches, steps)}``.  The advance runs one launch a forward
    chunk; the reverse one a chunk for phase A (all but the last) and one a
    chunk for its recompute."""
    chunk_r, nc_r, _ = reverse_layout(T, chunk)
    return {"advance": (len(forward_bounds(T, chunk)) - 1, T),
            "reverse": (2 * nc_r - 1, (nc_r - 1) * chunk_r + T)}


class FusedAdvance(NamedTuple):
    carry: Any        # the carry after the segment
    entries: List[Any]  # one carry per chunk entry, each leaf its own
    #                     allocation (on the card: page-locked host memory)
    ready: Any        # CUDA event after which the entries are final
    #                   (None: they already are)

    @property
    def boundaries(self) -> Any:
        """The chunk entries as the carry's structure with each leaf
        stacked ``(nc, ...)`` (a copy, for checks)."""
        spec = pytree.tree_structure(self.entries[0])
        leaves = [pytree.tree_leaves(e) for e in self.entries]
        return pytree.tree_unflatten(
            [torch.stack([e[i] for e in leaves])
             for i in range(len(leaves[0]))], spec)


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
    """The plain version of kernel 2: the carry over the segment plus a
    copy of every chunk-entry carry."""
    T = pytree.tree_leaves(xs_seg)[0].shape[0]
    bounds = forward_bounds(T, chunk)
    entries = []
    with torch.no_grad():
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            entries.append(pytree.tree_map(torch.clone, carry))
            for k in range(lo, hi):
                x = pytree.tree_map(lambda leaf: leaf[k], xs_seg)
                carry = body(params, carry, x, batch)
    return FusedAdvance(carry, entries, None)


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

# a host-side range around one part of a card path (allocations, the
# argument block, a replay); a profiler range, replaceable to time the
# parts on the host
_part = torch.profiler.record_function

# runner="fused" on the card runs captured segments (CapturedRun); False
# runs each segment through the uncaptured wrappers below, which allocate
# their buffers per call: the reference the captured run is held against
# (same kernels, same order, same data).  A private switch, not an option.
_CAPTURED = True

# a captured segment's argument block (csrc/lstm_step.cuh, SegArg)
ARG_TOK, ARG_TGT, ARG_STEP, ARG_BH, ARG_BC, ARG_BACC = range(6)
ARG_WORDS = 6


def _seg_lib():
    lib = build.load("segment_fused")
    if not getattr(lib, "_repro_typed", False):
        lib.lstm_adv_chunk.restype = _I
        lib.lstm_adv_chunk.argtypes = [_P, _P, _I, _I] + [_P] * 3 + [
            _I, _I] + [_P] * 8 + [_P, _I, _I, _P]
        lib.lstm_adv_finalize.restype = _I
        lib.lstm_adv_finalize.argtypes = [_P, _I, _P, _P, _P, _I, _I, _P,
                                          _P]
        lib.lstm_rev_scratch.restype = ctypes.c_long
        lib.lstm_rev_scratch.argtypes = [_I] * 4
        lib.lstm_rev_hoisted.restype = _I
        lib.lstm_rev_hoisted.argtypes = [_P, _P, _I, _I] + [_P] * 5 + [
            _I, _I, _P, _P, _I, _P]
        lib.lstm_rev_walk.restype = _I
        lib.lstm_rev_walk.argtypes = [_P, _I, _I] + [_P] * 6 + [
            _I, _I, _P, _P]
        lib.lstm_rev_walk_max_dh.restype = _I
        lib.lstm_rev_walk_max_dh.argtypes = []
        lib.lstm_rev_dx.restype = _I
        lib.lstm_rev_dx.argtypes = [_P, _I, _I, _P, _P, _I, _P, _P]
        lib.grad_reduce_slices.restype = _I
        lib.grad_reduce_slices.argtypes = [_I, _I, _I]
        lib.grad_reduce.restype = _I
        lib.grad_reduce.argtypes = [_P, _I, _P, _I, _I, _I, _I, _P, _I, _P,
                                    _P]
        lib.embed_grad.restype = _I
        lib.embed_grad.argtypes = [_P, _P, _I, _I, _I, _P, _I, _P, _P, _I,
                                   _I, _P]
        lib.add_inplace.restype = _I
        lib.add_inplace.argtypes = [_P, _P, ctypes.c_long, _P]
        lib.repro_device_address.restype = _I
        lib.repro_device_address.argtypes = [
            _P, ctypes.POINTER(ctypes.c_longlong)]
        lib._repro_typed = True
    return lib


_LSTM_KEYS = ("emb", "w", "b", "w_out", "b_out")


def _param_shapes(V, Dx, Dh):
    return [(V, Dx), (Dx + Dh, 4 * Dh), (4 * Dh,), (Dh, V), (V,)]


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
    if [tuple(t.shape) for t in p] != _param_shapes(V, Dx, Dh) \
            or c.shape != (B, Dh) or acc.shape != () \
            or tok.shape != tgt.shape or tok.shape[1:] != (B,):
        raise ValueError("fused LSTM kernels: operand shapes do not fit "
                         "the LSTM chain")
    tok = tok.to(device=dev, dtype=torch.int32).contiguous()
    tgt = tgt.to(device=dev, dtype=torch.int32).contiguous()
    return p, (h, c, acc), (tok, tgt), (V, Dx, Dh, B)


class _Ids(NamedTuple):
    """Where a segment's kernels read its token ids and targets: the
    segment's own ``(T, B)`` int32 rows (``tok``, ``tgt``), or a captured
    segment's argument block (``args``, on the card; the rows are then
    read from the addresses and the first step it holds)."""

    tok: Any
    tgt: Any
    args: Any

    def tok_rows(self, lo, hi):
        return None if self.args is not None else self.tok[lo:hi]

    def tgt_row(self, lo):
        return None if self.args is not None else self.tgt[lo]


class _AdvBufs(NamedTuple):
    hs: Any           # one chunk's states (index t = the input of step t)
    cs: Any
    lg: Any           # its logits
    msum: Any         # each step's mean loss over the segment
    acc_entries: Any  # the loss accumulator at each chunk entry
    barrier: Any      # the step loop's barrier counters


def _adv_bufs(dims, T, chunk, dev) -> _AdvBufs:
    V, Dx, Dh, B = dims
    bounds = forward_bounds(T, chunk)
    L_max = max(hi - lo for lo, hi in zip(bounds[:-1], bounds[1:]))
    f32 = torch.float32
    hs = torch.empty((L_max + 1, B, Dh), dtype=f32, device=dev)
    return _AdvBufs(hs, torch.empty_like(hs),
                    torch.empty((L_max * B, V), dtype=f32, device=dev),
                    torch.empty((T,), dtype=f32, device=dev),
                    torch.empty((len(bounds) - 1,), dtype=f32, device=dev),
                    torch.empty((-(-B // 16),), dtype=torch.int32,
                                device=dev))


def _advance_launches(lib, p, dims, T, chunk, bufs: _AdvBufs, ids: _Ids,
                      carry_in, carry_out, entries) -> None:
    """The fused advance's launches for one segment of ``T`` steps: per
    forward chunk the step loop, then its readout and loss (which write the
    chunk's entry into ``entries[k]``, page-locked ``(h, c, acc)``, or for
    ``entries[k] is None`` into the Level-2 slot named by ``ids.args``),
    then the loss accumulator's chain from ``carry_in`` into
    ``carry_out``."""
    from repro_torch.kernels.lstm_cell import lstm_cell_token_steps

    emb, w, b, w_out, b_out = p
    V, Dx, Dh, B = dims
    bounds = forward_bounds(T, chunk)
    spans = list(zip(bounds[:-1], bounds[1:]))
    nc, chunk = len(spans), min(int(chunk), T)
    ptr, stream = build.ptr, build.stream_ptr(carry_in[0].device)
    hs, cs, lg, msum, acc_entries, barrier = bufs
    for k, (lo, hi) in enumerate(spans):
        # chunk 0 steps from the segment's entry; each later one from hs[0],
        # cs[0], where the previous chunk's loss kernel put its exit
        entry = carry_in[:2] if k == 0 else (hs[0], cs[0])
        lstm_cell_token_steps(ids.tok_rows(lo, hi), emb, hs, cs, w, b,
                              barrier=barrier, entry=entry, args=ids.args,
                              tok_lo=lo, steps=hi - lo)
        nxt = carry_out[:2] if k == nc - 1 else (hs[0], cs[0])
        dst = entries[k]
        err = lib.lstm_adv_chunk(
            ptr(w_out), ptr(b_out), V, Dh, ptr(ids.tgt_row(lo)), ptr(hs),
            ptr(cs), hi - lo, B, ptr(lg), ptr(msum[lo]), ptr(entry[0]),
            ptr(entry[1]), ptr(None if dst is None else dst[0]),
            ptr(None if dst is None else dst[1]), ptr(nxt[0]), ptr(nxt[1]),
            ptr(ids.args), lo, int(dst is None), stream)
        build.check(lib, err, "fused_advance_segment (readout and loss)")
    err = lib.lstm_adv_finalize(ptr(msum), T, ptr(carry_in[2]),
                                ptr(carry_out[2]), ptr(acc_entries), chunk,
                                nc, ptr(ids.args), stream)
    build.check(lib, err, "fused_advance_segment (acc)")
    for k, dst in enumerate(entries):   # each entry's acc into its own word
        if dst is not None:
            dst[2].copy_(acc_entries[k], non_blocking=True)


def _advance_lstm_cuda(params, carry, xs_seg, chunk: int) -> FusedAdvance:
    lib = _seg_lib()
    p, carry, (tok, tgt), dims = _lstm_operands(params, carry, xs_seg)
    V, Dx, Dh, B = dims
    T = tok.shape[0]
    nc = len(forward_bounds(T, chunk)) - 1
    f32, dev = torch.float32, carry[0].device
    with _part("fused.alloc"):
        # the Level-2 copies: page-locked, written by the kernel through
        # UVA; each chunk entry's leaves are allocations of their own, so
        # Level 2 keeps exactly the entry it stores
        entries = [(torch.empty((B, Dh), dtype=f32, pin_memory=True),
                    torch.empty((B, Dh), dtype=f32, pin_memory=True),
                    torch.empty((), dtype=f32, pin_memory=True))
                   for _ in range(nc)]
        out = (torch.empty_like(carry[0]), torch.empty_like(carry[1]),
               torch.empty((), dtype=f32, device=dev))
        bufs = _adv_bufs(dims, T, chunk, dev)
    _advance_launches(lib, p, dims, T, chunk, bufs, _Ids(tok, tgt, None),
                      carry, out, entries)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    fused_advance_segment.launches += 1
    return FusedAdvance(out, entries, ready)


def _check_reverse_width(lib, w, Dh) -> None:
    if w.data_ptr() % 16:
        raise ValueError("fused LSTM reverse: w must be 16-byte aligned")
    max_dh = lib.lstm_rev_walk_max_dh()
    if Dh > max_dh:
        raise ValueError(
            f"fused LSTM reverse: hidden width {Dh} is above {max_dh}, the "
            f"widest whose walk tile (32 units of W_h) fits this device's "
            f"shared memory per block")


class _RevBufs(NamedTuple):
    hs: Any           # a chunk's recomputed states (index t = input of t)
    cs: Any
    ent_h: Any        # phase A: every chunk-entry (h, c); [0] the segment's
    ent_c: Any
    barrier: Any      # the cooperative launches' barrier counters
    acts: Any
    xh: Any
    dz: Any
    dl: Any
    dh_extra: Any
    dx: Any
    part: Any         # the slices' partial sums of the split reductions
    gflat: Any        # the segment's parameter gradient, flat
    tail: Any         # a short tail chunk's, added once at the end


def _grad_layout(V, Dx, Dh):
    """Offsets and sizes of the flat gradient ``[emb | w ; b | w_out ;
    b_out]``: each fixed-order reduction writes its (rows + bias row)
    block in place."""
    sizes = [V * Dx, (Dx + Dh) * 4 * Dh, 4 * Dh, Dh * V, V]
    return [sum(sizes[:i]) for i in range(len(sizes))], sizes


def _rev_bufs(lib, dims, T, chunk, dev) -> _RevBufs:
    V, Dx, Dh, B = dims
    chunk, nc, rem = reverse_layout(T, chunk)
    K, N4, f32 = Dx + Dh, 4 * Dh, torch.float32
    total = sum(_grad_layout(V, Dx, Dh)[1])
    hs = torch.empty((chunk + 1, B, Dh), dtype=f32, device=dev)
    ent_h = torch.empty((nc, B, Dh), dtype=f32, device=dev)
    gflat = torch.empty((total,), dtype=f32, device=dev)
    return _RevBufs(
        hs, torch.empty_like(hs), ent_h, torch.empty_like(ent_h),
        torch.empty((-(-B // 16),), dtype=torch.int32, device=dev),
        torch.empty((chunk, B, N4), dtype=f32, device=dev),
        torch.empty((chunk, B, K), dtype=f32, device=dev),
        torch.empty((chunk, B, N4), dtype=f32, device=dev),
        torch.empty((chunk, B, V), dtype=f32, device=dev),
        torch.empty((chunk, B, Dh), dtype=f32, device=dev),
        torch.empty((chunk, B, Dx), dtype=f32, device=dev),
        torch.empty((max(1, *(lib.lstm_rev_scratch(V, Dx, Dh, n * B)
                               for n in {chunk, rem})),),
                    dtype=f32, device=dev),
        gflat, torch.empty_like(gflat) if rem != chunk else None)


def _reverse_launches(lib, p, dims, T, chunk, bufs: _RevBufs, ids: _Ids,
                      dh, dc, dacc) -> None:
    """The fused reverse's launches for one segment of ``T`` steps, from
    its entry state in ``bufs.ent_h[0]``, ``bufs.ent_c[0]``: ``dh``, ``dc``
    go from the exit's cotangents to the entry's in place, and
    ``bufs.gflat`` gets the segment's parameter gradient (the first chunk
    folded writes it, so nothing is zero-filled)."""
    from repro_torch.kernels.lstm_cell import lstm_cell_token_steps

    emb, w, b, w_out, b_out = p
    V, Dx, Dh, B = dims
    chunk, nc, rem = reverse_layout(T, chunk)
    K, N4 = Dx + Dh, 4 * Dh
    offs, sizes = _grad_layout(V, Dx, Dh)
    ptr, stream = build.ptr, build.stream_ptr(dh.device)
    hs, cs, ent_h, ent_c, barrier = bufs[:5]
    acts, xh, dz, dl, dh_extra, dx, part, gflat, tail = bufs[5:]
    # phase A: every chunk-entry (h, c), recomputed from the boundary
    for kk in range(1, nc):
        lo = (kk - 1) * chunk
        hs[0].copy_(ent_h[kk - 1])
        cs[0].copy_(ent_c[kk - 1])
        lstm_cell_token_steps(ids.tok_rows(lo, kk * chunk), emb, hs, cs, w,
                              b, barrier=barrier, args=ids.args, tok_lo=lo,
                              steps=chunk)
        ent_h[kk].copy_(hs[chunk])
        ent_c[kk].copy_(cs[chunk])
    first = True   # the first full chunk folded writes gflat
    for kk in range(nc - 1, -1, -1):
        lo, hi = kk * chunk, min((kk + 1) * chunk, T)
        L, M = hi - lo, (hi - lo) * B
        hs[0].copy_(ent_h[kk])
        cs[0].copy_(ent_c[kk])
        lstm_cell_token_steps(ids.tok_rows(lo, hi), emb, hs, cs, w, b,
                              xh=xh, acts=acts, barrier=barrier,
                              args=ids.args, tok_lo=lo, steps=L)
        err = lib.lstm_rev_hoisted(ptr(w_out), ptr(b_out), V, Dh,
                                   ptr(ids.tgt_row(lo)), ptr(hs[1]),
                                   ptr(dacc), ptr(dl), ptr(dh_extra), M, B,
                                   ptr(part), ptr(ids.args), lo, stream)
        build.check(lib, err, "fused_reverse_segment (hoisted products)")
        err = lib.lstm_rev_walk(ptr(w), Dx, Dh, ptr(cs), ptr(acts),
                                ptr(dh_extra), ptr(dh), ptr(dc), ptr(dz), L,
                                B, ptr(barrier), stream)
        build.check(lib, err, "fused_reverse_segment (walk)")
        err = lib.lstm_rev_dx(ptr(w), Dx, Dh, ptr(dz), ptr(dx), M, ptr(part),
                              stream)
        build.check(lib, err, "fused_reverse_segment (dx)")
        if kk == nc - 1 and rem != chunk:
            dst, acc = tail, 0   # a short tail: added once at the end
        else:
            dst, acc = gflat, int(not first)
            first = False
        base, fbytes = dst.data_ptr(), dst.element_size()
        err = lib.grad_reduce(ptr(xh), K, ptr(dz), N4, M, K, N4,
                              _P(base + offs[1] * fbytes), acc, ptr(part),
                              stream)
        build.check(lib, err, "fused_reverse_segment (dW)")
        err = lib.grad_reduce(ptr(hs[1]), Dh, ptr(dl), V, M, Dh, V,
                              _P(base + offs[3] * fbytes), acc, ptr(part),
                              stream)
        build.check(lib, err, "fused_reverse_segment (dw_out)")
        err = lib.embed_grad(ptr(ids.tok_rows(lo, hi)), ptr(dx), M, V, Dx,
                             _P(base + offs[0] * fbytes), acc, ptr(part),
                             ptr(ids.args), lo, B, stream)
        build.check(lib, err, "fused_reverse_segment (demb)")
    if tail is not None:
        err = lib.add_inplace(ptr(gflat), ptr(tail), gflat.numel(), stream)
        build.check(lib, err, "fused_reverse_segment (tail fold)")


def _grad_views(gflat, dims) -> Dict[str, Any]:
    """The flat gradient as the LSTM chain's parameter dict (views)."""
    V, Dx, Dh, _ = dims
    offs, sizes = _grad_layout(V, Dx, Dh)
    return {k: gflat[o:o + n].view(s) for k, o, n, s in
            zip(_LSTM_KEYS, offs, sizes, _param_shapes(V, Dx, Dh))}


def _reverse_lstm_cuda(params, carry_b, xs_seg, dcarry, chunk: int):
    """One uncaptured fused reverse: ``((dh, dc, dacc), gflat)``."""
    lib = _seg_lib()
    p, (h_b, c_b, _), (tok, tgt), dims = _lstm_operands(
        params, carry_b, xs_seg)
    _check_reverse_width(lib, p[1], dims[2])
    dh_in, dc_in, dacc = dcarry
    T = tok.shape[0]
    f32, dev = torch.float32, h_b.device
    with _part("fused.alloc"):
        bufs = _rev_bufs(lib, dims, T, chunk, dev)
    bufs.ent_h[0].copy_(h_b)
    bufs.ent_c[0].copy_(c_b)
    dh = dh_in.to(f32).contiguous().clone()
    dc = dc_in.to(f32).contiguous().clone()
    dacc = dacc.to(dtype=f32, device=dev).contiguous()
    _reverse_launches(lib, p, dims, T, chunk, bufs, _Ids(tok, tgt, None),
                      dh, dc, dacc)
    fused_reverse_segment.launches += 1
    return (dh, dc, dacc.clone()), bufs.gflat


# --------------------------------------------------------------------------
# captured segments: one CUDA graph per segment shape and direction
# --------------------------------------------------------------------------


def _capture(launch):
    """A CUDA graph of ``launch()`` and the ``lstm_cell`` launches and cell
    steps it holds: one warm-up run on a side stream (it does the work for
    real, so a replay after it recomputes the same values), then the
    capture on that stream; what the step loop's counters grew by while
    ``launch()`` was captured is what each replay launches.  The counters
    are left as they were before the warm-up (it is not a launch of the
    caller's work).  Raises if either fails: there is no uncaptured
    fallback.  The launches allocate nothing, so the capture is begun and
    ended directly (``torch.cuda.graph`` would also empty the caching
    allocator first, and the next call would then allocate anew what the
    run had cached)."""
    from repro_torch.kernels.lstm_cell import lstm_cell

    before = (lstm_cell.launches, lstm_cell.steps)
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        launch()
        n0, s0 = lstm_cell.launches, lstm_cell.steps
        # thread_local: the Level-2 threads may call the runtime meanwhile
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            launch()
        finally:
            graph.capture_end()
        held = (lstm_cell.launches - n0, lstm_cell.steps - s0)
    cur.wait_stream(side)
    lstm_cell.launches, lstm_cell.steps = before
    return graph, held


class _ArgRing:
    """Page-locked staging for the argument blocks: each replay's block is
    copied host to device on the compute stream before it.  A staging row
    is rewritten only after its copy has completed: the ring is cut into
    blocks of rows, an event is recorded after a block's last copy, and a
    block is reused only once that event has completed.  (Each CUDA call
    hands the interpreter lock to the Level-2 threads, which costs the
    caller ~0.1-0.2 ms a call on the card's host under load: one copy a
    replay, one event a block.)"""

    ROWS, BLOCK = 4096, 512

    def __init__(self, dev):
        self.rows = torch.empty((self.ROWS, ARG_WORDS), dtype=torch.int64,
                                pin_memory=dev.type == "cuda")
        self.view = self.rows.numpy()
        self.events = [None] * (self.ROWS // self.BLOCK)
        self.i = 0

    def write(self, dst, words) -> None:
        i = self.i
        self.i = (i + 1) % self.ROWS
        block, first = divmod(i, self.BLOCK)
        if first == 0 and self.events[block] is not None:
            self.events[block].synchronize()   # its copies have run
        self.view[i] = words
        dst.copy_(self.rows[i], non_blocking=True)
        if first == self.BLOCK - 1:
            if self.events[block] is None:
                self.events[block] = torch.cuda.Event()
            self.events[block].record(torch.cuda.current_stream())


class _SegmentGraphs:
    """The captured advance and reverse of one segment shape ``(B, T,
    chunk)`` of the LSTM chain at widths ``(V, Dx, Dh)`` on one device —
    the counterpart of the JAX runner's jit cache (``_fused_ops``'
    ``lru_cache`` per body and chunk, and jit's cache per shape).

    It holds the static buffers its graphs were captured with: the
    parameters' static copy (shared by every shape at these widths, written
    by each :class:`CapturedRun` as it starts), the scratch the uncaptured
    wrappers allocate per call, the argument blocks, and two
    carries per direction that the graphs ping-pong between (the
    counterpart of donating the carry: segment k+1 reads the buffer
    segment k wrote).  ``graphs[(direction, p)]`` reads pair ``p`` and
    writes pair ``1 - p``; each is captured at its first use, with the
    ``lstm_cell`` launches and steps it holds (:func:`_capture`)."""

    def __init__(self, lib, dims, T: int, chunk: int, dev, params):
        B, Dh = dims[3], dims[2]
        f32 = torch.float32
        self.lib, self.dims, self.T, self.chunk = lib, dims, T, chunk
        self.params = params

        def pair():
            return [(torch.empty((B, Dh), dtype=f32, device=dev),
                     torch.empty((B, Dh), dtype=f32, device=dev),
                     torch.empty((), dtype=f32, device=dev))
                    for _ in range(2)]

        self.carry, self.dcarry = pair(), pair()
        self.adv = _adv_bufs(dims, T, chunk, dev)
        self.rev = _rev_bufs(lib, dims, T, chunk, dev)
        self.args = {d: torch.zeros((ARG_WORDS,), dtype=torch.int64,
                                    device=dev)
                     for d in ("advance", "reverse")}
        self.graphs: Dict[Tuple[str, int], Any] = {}
        self.nc = len(forward_bounds(T, chunk)) - 1

    @staticmethod
    def parity(pairs, tree) -> int:
        """Which pair ``tree`` is, or -1."""
        for i, pr in enumerate(pairs):
            if all(a is b for a, b in zip(pr, tree)):
                return i
        return -1

    def _launch_advance(self, p: int, scratch) -> None:
        ids = _Ids(None, None, self.args["advance"])
        entries = [None] + [scratch[k % 2] for k in range(self.nc - 1)]
        _advance_launches(self.lib, self.params, self.dims, self.T,
                          self.chunk, self.adv, ids, self.carry[p],
                          self.carry[1 - p], entries)

    def _launch_reverse(self, p: int) -> None:
        _check_reverse_width(self.lib, self.params[1], self.dims[2])
        src, dst = self.dcarry[p], self.dcarry[1 - p]
        for a, b in zip(dst, src):   # the reverse works in place on dst
            a.copy_(b)
        ids = _Ids(None, None, self.args["reverse"])
        _reverse_launches(self.lib, self.params, self.dims, self.T,
                          self.chunk, self.rev, ids, *dst)

    def replay(self, direction: str, p: int, launch) -> Tuple[int, int]:
        """Replay the graph of ``direction`` reading carry pair ``p``,
        capturing it first if this is its first use; returns the
        ``lstm_cell`` launches and steps the graph holds."""
        entry = self.graphs.get((direction, p))
        if entry is None:
            entry = self.graphs[(direction, p)] = _capture(launch)
            CapturedRun.captures += 1
        graph, held = entry
        with _part("fused.replay"):
            graph.replay()
        return held


_GRAPHS: Dict[Tuple, _SegmentGraphs] = {}
_PARAMS: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
_POOLS: Dict[Tuple, Any] = {}
_RINGS: Dict[Any, _ArgRing] = {}
_ADDRESS: Dict[int, int] = {}


def clear_caches() -> None:
    """Drop the captured graphs, their workspaces, the parameters' static
    copies and the Level-2 slot pools (the counterpart of
    ``jax.clear_caches``): the device and page-locked memory they hold goes
    back to the caching allocators once nothing else holds it, and the next
    captured run captures and allocates anew."""
    _GRAPHS.clear()
    _PARAMS.clear()
    _POOLS.clear()
    _RINGS.clear()
    _ADDRESS.clear()


def _device_address(lib, t) -> int:
    """The address a kernel writes ``t`` (page-locked host memory) at."""
    host = t.data_ptr()
    dev = _ADDRESS.get(host)
    if dev is None:
        out = ctypes.c_longlong()
        build.check(lib, lib.repro_device_address(_P(host),
                                                  ctypes.byref(out)),
                    "Level-2 slot address")
        dev = _ADDRESS[host] = out.value
    return dev


def _count(wrapper, held: Tuple[int, int]) -> None:
    """One replay of ``wrapper``'s graph: one launch of the wrapper and the
    step loop's launches and steps the graph holds (``held``), as the
    uncaptured wrapper counts them."""
    from repro_torch.kernels.lstm_cell import lstm_cell

    n, steps = held
    wrapper.launches += 1
    wrapper.cell_launches += n
    wrapper.cell_steps += steps
    lstm_cell.launches += n
    lstm_cell.steps += steps


class CapturedRun:
    """One gradient call's fused segments on the card as CUDA graph
    replays: one replay per segment and direction, on the graphs of
    :class:`_SegmentGraphs` (captured at a shape's first use, kept for
    later calls), with Level-2 boundaries written into slots of a
    :class:`~repro_torch.core.storage.PinnedSlotPool` and no allocation per
    segment.  The same kernels run in the same order on the same data as
    in :func:`fused_advance_segment` and :func:`fused_reverse_segment`, so
    the results are bit for bit theirs; each replay adds to the launch
    counters the launches its graph holds, as counted when it was captured.
    The graphs read a static copy of the parameters, written once as the
    run starts: a run's parameters must not change while it runs.

    ``params``: the LSTM chain's parameters; ``xs``: the chain's ``(tok,
    tgt)``, ``(n, B)`` each.  A failed capture or replay raises."""

    captures = 0   # graphs captured in this process

    def __init__(self, body, params, xs):
        body_kind(body)
        self.lib = _seg_lib()
        p = [params[k] for k in _LSTM_KEYS]
        tok, tgt = xs
        dev = p[0].device
        V, Dx = p[0].shape
        Dh = p[3].shape[0]
        B = tok.shape[1]
        self.dims, self.dev = (V, Dx, Dh, B), dev
        wkey = (V, Dx, Dh, dev)
        if wkey not in _PARAMS:
            _PARAMS[wkey] = tuple(torch.empty(sh, dtype=torch.float32,
                                              device=dev)
                                  for sh in _param_shapes(V, Dx, Dh))
        self.params = _PARAMS[wkey]
        with torch.no_grad():
            torch._foreach_copy_(list(self.params), p)
        self.tok = tok.to(device=dev, dtype=torch.int32).contiguous()
        self.tgt = tgt.to(device=dev, dtype=torch.int32).contiguous()
        key = (B, Dh, dev)
        if key not in _POOLS:
            from repro_torch.core.storage import PinnedSlotPool

            _POOLS[key] = PinnedSlotPool([(B, Dh), (B, Dh), ()],
                                         torch.float32,
                                         pin=dev.type == "cuda")
        self.pool = _POOLS[key]
        # the autotuner's probe holds one slot while it takes the next
        self.pool.reserve(2)
        if dev not in _RINGS:
            _RINGS[dev] = _ArgRing(dev)
        self.ring = _RINGS[dev]

    def graphs(self, T: int, chunk: int) -> _SegmentGraphs:
        chunk = min(int(chunk), T)
        key = (self.dims, T, chunk, self.dev)
        ws = _GRAPHS.get(key)
        if ws is None:
            ws = _GRAPHS[key] = _SegmentGraphs(self.lib, self.dims, T,
                                               chunk, self.dev, self.params)
        return ws

    def _words(self, step0: int, slot=()) -> List[int]:
        return [self.tok.data_ptr(), self.tgt.data_ptr(), int(step0)] + [
            _device_address(self.lib, t) for t in slot] + [0] * (
            3 - len(slot))

    def advance(self, carry, step0: int, T: int, chunk: int, *,
                last: bool) -> FusedAdvance:
        """The segment ``[step0, step0 + T)`` from ``carry``:
        ``FusedAdvance(carry_out, entries, ready)``, ``entries[0]`` the
        segment-entry state in a pooled page-locked slot (final once
        ``ready`` has completed).  ``carry_out`` is one of the graphs'
        carry buffers, which the next replay of this shape overwrites
        (it reads it), unless ``last``: then a copy."""
        ws = self.graphs(T, chunk)
        with torch.profiler.record_function("fused_advance_segment"):
            p = ws.parity(ws.carry, carry)
            if p < 0:
                p = 0
                torch._foreach_copy_(list(ws.carry[0]), list(carry))
            slot, leaves = self.pool.take()
            with _part("fused.args"):
                self.ring.write(ws.args["advance"],
                                self._words(step0, self.pool.leaves(slot)))
            held = ws.replay("advance", p, lambda: ws._launch_advance(
                p, self.pool.scratch))
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream())
            out = ws.carry[1 - p]
            if last:
                out = tuple(t.clone() for t in out)
        _count(fused_advance_segment, held)
        entries = [leaves] + [self.pool.scratch[k % 2]
                              for k in range(ws.nc - 1)]
        return FusedAdvance(out, entries, ready)

    def reverse(self, carry_b, dcarry, step0: int, T: int, chunk: int, *,
                last: bool):
        """The segment ``[step0, step0 + T)`` reversed from its boundary
        ``carry_b`` at the cotangent ``dcarry`` of its exit:
        ``((dh, dc, dacc), gflat)``, ``gflat`` the segment's flat parameter
        gradient (a buffer of the graph, read before the next replay of
        this shape).  The cotangents are one of the graphs' pairs unless
        ``last`` (then copies)."""
        ws = self.graphs(T, chunk)
        with torch.profiler.record_function("fused_reverse_segment"):
            p = ws.parity(ws.dcarry, dcarry)
            dst, src = [ws.rev.ent_h[0], ws.rev.ent_c[0]], list(carry_b[:2])
            if p < 0:
                p = 0
                dst += ws.dcarry[0]
                src += dcarry
            torch._foreach_copy_(dst, src)   # one call for every copy
            with _part("fused.args"):
                self.ring.write(ws.args["reverse"], self._words(step0))
            held = ws.replay("reverse", p, lambda: ws._launch_reverse(p))
            out = ws.dcarry[1 - p]
            if last:
                out = tuple(t.clone() for t in out)
        _count(fused_reverse_segment, held)
        return out, ws.rev.gflat


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _card_call(wrapper):
    """A profiler range named after ``wrapper`` around its card path, and
    the kernel-1 launches and cell steps made inside it added to
    ``wrapper.cell_launches`` and ``wrapper.cell_steps``: kernel 1's work
    by caller (the advance's chunks, the reverse's recompute)."""
    from repro_torch.kernels.lstm_cell import lstm_cell

    n0, s0 = lstm_cell.launches, lstm_cell.steps
    with torch.profiler.record_function(wrapper.__name__):
        yield
    wrapper.cell_launches += lstm_cell.launches - n0
    wrapper.cell_steps += lstm_cell.steps - s0


def fused_advance_segment(body, params, carry, xs_seg, batch, *,
                          chunk: int) -> FusedAdvance:
    """Advance the carry over one segment with the fused forward kernels.

    Returns ``FusedAdvance(carry_out, entries, ready)``: ``entries`` holds
    one carry per chunk entry (on the card: page-locked host tensors written
    by the kernels, each leaf its own allocation, final once ``ready`` has
    completed); ``entries[0]`` is the segment-entry state the executor
    stores to Level 2.  (Uncaptured: its buffers are allocated per call;
    :class:`CapturedRun` replays the same kernels.)"""
    if _on_cpu(carry):
        return advance_plain(body, params, carry, xs_seg, batch, chunk=chunk)
    body_kind(body)
    with _card_call(fused_advance_segment):
        return _advance_lstm_cuda(params, carry, xs_seg, chunk)


fused_advance_segment.launches = 0
fused_advance_segment.cell_launches = 0
fused_advance_segment.cell_steps = 0


def _fused_reverse_card(body, params, carry_b, xs_seg, dcarry, *,
                        chunk: int):
    """The uncaptured card path of :func:`fused_reverse_segment`:
    ``(dcarry_at_begin, gflat)``, the gradient flat
    (:func:`_grad_views` gives the dict)."""
    body_kind(body)
    with _card_call(fused_reverse_segment):
        return _reverse_lstm_cuda(params, carry_b, xs_seg, dcarry, chunk)


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
    dc, gflat = _fused_reverse_card(body, params, carry_b, xs_seg, dcarry,
                                    chunk=chunk)
    V, Dx = params["emb"].shape
    dims = (V, Dx, dc[0].shape[1], dc[0].shape[0])
    return dc, _grad_views(gflat, dims), []


fused_reverse_segment.launches = 0
fused_reverse_segment.cell_launches = 0
fused_reverse_segment.cell_steps = 0
