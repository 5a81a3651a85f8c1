"""The generic-body fused segments (``csrc/segment_generic.cu``):
``runner="fused"`` for any chain body, the counterpart of the JAX
package's ``runner="pallas"`` on a body it traces into its kernels.

The TPU kernels (``repro/kernels/segment_pallas.py::fused_advance_segment``
and ``::fused_reverse_segment``) trace the caller's body into a
``pallas_call`` and do their own work around it.  On the card the body's
steps, the reverse's recompute and the chunks' vjps -- the kernels'
arithmetic -- run as the caller's code on the compute stream, exactly as
``runner="compiled"`` runs them (no hand-written kernel computes an
arbitrary Python body).  For gemma2-2b's body that code is partly the
port's hand-written layer kernels (``flash_attention`` and its backward,
``rmsnorm``, ``glu``, ``rope``, each forward and backward); its
projections, which the TPU kernel computes inside its traced body, still
run on cuBLAS (``torch.matmul``), and its weight casts and gradient adds
as PyTorch's own kernels, so that body's half of the TPU kernels is only
partly ported.  Other bodies (mamba2-370m's: the SSD backward, the gated
norm, the depthwise conv) still run plain PyTorch arithmetic there
(ROADMAP queue 2).  This module
hand-writes the segments' own data movement, two kernels, each one launch
over a table of leaves:

* :func:`entry_store` — each chunk-entry carry copied into page-locked host
  slots (one slot a leaf, from the pools of
  :func:`repro_torch.core.offload._slot`, each owning its storage as Level 2
  requires) on the process's device-to-host side stream, after an event
  recorded on the compute stream at the chunk entry, so the chunk's steps
  run beside it: the advance's asynchronous copies to the boundary buffer.
* :func:`fold` — one reverse chunk's cotangents: the parameter cotangent
  added into the executor's accumulator in place (a leaf the steps did not
  read, a broadcast zero, is skipped), and the differentiable input
  cotangents copied into their rows of the full-chain buffer (the TPU
  kernel's ``dxd`` rows, written in place at each chunk).

:func:`advance` and :func:`reverse` are the segments around them, on the
TPU kernels' chunk walks (``segment_fused.forward_walk`` and
``reverse_walk``).  The advance stores every chunk entry, as the TPU kernel
does, the first into slots of its own for Level 2 and the rest into the
pools' scratch pair.  The reverse recomputes the chunk entries from the
Level-2 boundary (phase A, kept in device memory: on the TPU the spill goes
to HBM too), then walks the chunks from the last one down with one
``steps_vjp`` a chunk and one :func:`fold` a chunk; a short tail chunk's
parameter cotangent is added once at the end, in chunk 0's launch after
chunk 0's own (the TPU kernel's association).  On CPU tensors
each wrapper runs its plain version; on CUDA tensors it launches its kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import Any, List, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.api.chain import is_broadcast_zero, steps_vjp, zero_grads
from repro_torch.kernels import build
from repro_torch.kernels.segment_fused import (FusedAdvance, _device_address,
                                               _slice, forward_walk,
                                               reverse_walk)

_P = ctypes.c_void_p
_I = ctypes.c_int

# fold's op word (csrc/segment_generic.cu)
OP_ACC, FRESH, DST_BF16, SRC_BF16, SRC2_BF16 = 1, 2, 4, 8, 16
_ADD_TYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = build.load("segment_generic")
    if not getattr(lib, "_repro_typed", False):
        for name in ("generic_entry_store", "generic_fold"):
            fn = getattr(lib, name)
            fn.restype = _I
            fn.argtypes = [_P, _I, _P]
        lib.repro_device_address.restype = _I
        lib.repro_device_address.argtypes = [
            _P, ctypes.POINTER(ctypes.c_longlong)]
        lib._repro_typed = True
    return lib


def _on_cpu(tensors: Sequence[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU; ``ValueError`` for CPU
    tensors beside CUDA ones (there is no mixed path)."""
    cuda = [t.is_cuda for t in tensors]
    if any(cuda) and not all(cuda):
        raise ValueError("the generic fused kernels take tensors on one "
                         "device: got CPU tensors beside CUDA ones")
    return not any(cuda)


def _streams(dev):
    """``(compute, side)``: the current stream and the process's
    device-to-host side stream of ``dev``."""
    from repro_torch.core.storage import _side_stream

    return torch.cuda.current_stream(dev), _side_stream("d2h", dev)


def _hold(tensors, stream) -> None:
    """Keep the caching allocator from reusing ``tensors``' memory before
    the work queued on ``stream`` has read them."""
    for t in tensors:
        t.record_stream(stream)


def _table(words: List[int], dev) -> torch.Tensor:
    """A launch's table as int64 words on ``dev``: copied from page-locked
    memory on the current stream (the caching host allocator keeps the
    staging buffer until the copy has run)."""
    t = torch.tensor(words, dtype=torch.int64)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


# --------------------------------------------------------------------------
# entry_store
# --------------------------------------------------------------------------


def entry_store_plain(srcs, dsts) -> None:
    """The plain version of :func:`entry_store`: ``dst.copy_(src)`` per
    leaf."""
    for s, d in zip(srcs, dsts):
        d.copy_(s)


def entry_store(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor]):
    """Copy one chunk-entry carry's leaves ``srcs`` into the host slots
    ``dsts`` (same shapes and types; on the card page-locked, each owning
    its storage).  Returns the CUDA event after which ``dsts`` hold the
    values (``None`` on the CPU, where they already do).

    On the card: one launch on the device-to-host side stream, after the
    work queued so far on the compute stream; a non-contiguous leaf is made
    contiguous first (a copy on the compute stream).  ``srcs`` are kept
    from reuse until the launch has read them, so the caller may drop them
    at once.  Every launch of this process goes on that one stream, so a
    slot that went back to its pool before its copy ran is written again
    only after it."""
    srcs, dsts = list(srcs), list(dsts)
    if len(srcs) != len(dsts) or any(
            s.shape != d.shape or s.dtype != d.dtype
            for s, d in zip(srcs, dsts)):
        raise ValueError("entry_store: every slot must have its leaf's "
                         "shape and dtype")
    if _on_cpu(srcs):
        entry_store_plain(srcs, dsts)
        return None
    if any(d.is_cuda or not d.is_contiguous() for d in dsts):
        raise ValueError("entry_store: the slots must be contiguous host "
                         "memory")
    lib = _lib()
    srcs = [s.contiguous() for s in srcs]
    dev = srcs[0].device
    words = []
    for s, d in zip(srcs, dsts):
        n = s.numel() * s.element_size()
        if n:
            words += [s.data_ptr(), _device_address(lib, d), n]
    compute, side = _streams(dev)
    side.wait_stream(compute)   # the chunk entry, as the compute stream has it
    with torch.cuda.stream(side):
        table = _table(words, dev)
        err = lib.generic_entry_store(build.ptr(table), len(words) // 3,
                                      _P(side.cuda_stream))
        build.check(lib, err, "entry_store")
        _hold(srcs, side)
        ready = torch.cuda.Event()
        ready.record(side)
    entry_store.launches += 1
    return ready


entry_store.launches = 0


# --------------------------------------------------------------------------
# fold
# --------------------------------------------------------------------------


def fold_plan(gacc, dps, dst_rows, src_rows):
    """What one chunk's fold does: ``(new accumulator leaves, [(dst, srcs,
    kind), ...])``.  ``dps``: the parameter cotangents to add, in order
    (the chunk's; in a segment's last launch also a short tail chunk's).
    For each accumulator leaf, the cotangents that are not broadcast zeros
    (a parameter the steps did not read) are added in order: into the leaf
    in place (``"add"``; made contiguous first if it is not), or, where the
    leaf is still a broadcast zero, into a buffer of its own that starts
    from the first of them (``"fresh"``).  Then each ``src_rows`` tensor is
    copied into ``dst_rows`` (``"copy"``; views of the full-chain
    input-cotangent buffer)."""
    acc = pytree.tree_leaves(gacc)
    grads = [pytree.tree_leaves(dp) for dp in dps]
    if any(len(g) != len(acc) for g in grads) or \
            len(dst_rows) != len(src_rows):
        raise ValueError("fold: the cotangents do not match the "
                         "accumulator's structure")
    ops = []
    for i, a in enumerate(acc):
        srcs = [g[i].contiguous() for g in grads
                if not is_broadcast_zero(g[i])]
        if not srcs:
            continue
        if any(g.shape != a.shape for g in srcs):
            raise ValueError(f"fold: cotangents of shapes "
                             f"{[tuple(g.shape) for g in srcs]} for an "
                             f"accumulator leaf of {tuple(a.shape)}")
        if is_broadcast_zero(a):
            acc[i] = torch.empty_like(srcs[0],
                                      memory_format=torch.contiguous_format)
            ops.append((acc[i], srcs, "fresh"))
        else:
            if not a.is_contiguous():
                acc[i] = a = a.contiguous()
            ops.append((a, srcs, "add"))
    for d, s in zip(dst_rows, src_rows):
        if d.shape != s.shape:
            raise ValueError(f"fold: rows of shape {tuple(s.shape)} for "
                             f"{tuple(d.shape)}")
        ops.append((d, [s.contiguous()], "copy"))
    return acc, ops


def fold_plain(ops) -> None:
    """The plain version of :func:`fold`'s launch, in order: a copy,
    ``dst.copy_(src)``; an add, ``dst.add_(src)`` for each source; a fresh
    leaf, ``dst.copy_`` of its first source, then ``add_`` of the rest."""
    for d, srcs, kind in ops:
        for j, s in enumerate(srcs):
            if kind == "add" or j > 0:
                d.add_(s)
            else:
                d.copy_(s)


def _fold_words(ops) -> List[int]:
    words = []
    for d, srcs, kind in ops:
        if kind == "copy":
            s = srcs[0]
            if d.dtype != s.dtype or not d.is_contiguous():
                raise ValueError("fold: a copy needs a contiguous "
                                 "destination of its source's dtype")
            count = d.numel() * d.element_size()
            if count:
                words += [d.data_ptr(), s.data_ptr(), 0, count, 0]
            continue
        if len(srcs) > 2 or any(t.dtype not in _ADD_TYPES
                                for t in [d] + srcs):
            raise ValueError(
                f"fold: the kernel adds at most two fp32 or bf16 "
                f"cotangents into an fp32 or bf16 leaf, got "
                f"{[t.dtype for t in srcs]} into {d.dtype}")
        op = OP_ACC | (FRESH if kind == "fresh" else 0) | (
            DST_BF16 if d.dtype == torch.bfloat16 else 0)
        for t, bit in zip(srcs, (SRC_BF16, SRC2_BF16)):
            if t.dtype == torch.bfloat16:
                op |= bit
        if d.numel():
            words += [d.data_ptr(), srcs[0].data_ptr(),
                      srcs[1].data_ptr() if len(srcs) > 1 else 0,
                      d.numel(), op]
    return words


def fold(gacc, dps, dst_rows=(), src_rows=()):
    """One reverse chunk's fold: the parameter cotangents ``dps`` (a list of
    trees, added in order) into the accumulator ``gacc`` in place and the
    chunk's input cotangents ``src_rows`` into ``dst_rows`` (see
    :func:`fold_plan`).  Returns the accumulator tree (the leaves that got
    a buffer here are new).  On the card: one launch on the compute
    stream."""
    leaves = pytree.tree_leaves(gacc)
    spec = pytree.tree_structure(gacc)
    acc, ops = fold_plan(gacc, dps, list(dst_rows), list(src_rows))
    tensors = leaves + [t for dp in dps for t in pytree.tree_leaves(dp)] \
        + list(dst_rows) + list(src_rows)
    if _on_cpu(tensors):
        fold_plain(ops)
    else:
        lib = _lib()
        dev = tensors[0].device
        words = _fold_words(ops)
        table = _table(words, dev)
        err = lib.generic_fold(build.ptr(table), len(words) // 5,
                               build.stream_ptr(dev))
        build.check(lib, err, "fold")
        fold.launches += 1
    return pytree.tree_unflatten(acc, spec)


fold.launches = 0


# --------------------------------------------------------------------------
# the segments
# --------------------------------------------------------------------------


def advance(body, params, carry, xs_seg, batch, *,
            chunk: int) -> FusedAdvance:
    """The segment's forward with the TPU kernel's chunk layout: at each
    chunk entry the carry goes to host slots by :func:`entry_store` while
    the chunk's steps run.  Returns ``FusedAdvance(carry_out, entries,
    ready)``: ``entries[0]``, the segment entry Level 2 keeps, in slots of
    its own (each leaf owning its storage); the later chunk entries, which
    no one reads, in the pools' two scratch slots (as the captured LSTM
    segment writes them), so ``entries[k]`` past the first holds its value
    only until the store two chunks later.  Final once ``ready`` (the last
    store's event; every store rides one stream) has completed."""
    from repro_torch.core.offload import _scratch_slot, _slot

    spec = pytree.tree_structure(carry)
    entries, ready = [], None

    def store(kk, c):
        nonlocal ready
        leaves = pytree.tree_leaves(c)
        slots = [_slot(t, pin=t.is_cuda) if kk == 0 else
                 _scratch_slot(t, t.is_cuda, kk - 1) for t in leaves]
        ready = entry_store(leaves, slots) or ready
        entries.append(pytree.tree_unflatten(slots, spec))

    carry = forward_walk(body, params, carry, xs_seg, batch, chunk=chunk,
                         at_entry=store)
    return FusedAdvance(carry, entries, ready)


def reverse(body, xs_mask, params, carry_b, xs_seg, batch, dcarry, gacc,
            dx_rows: Sequence[torch.Tensor], *, chunk: int):
    """Reverse one segment from its Level-2 boundary ``carry_b`` at the
    cotangent ``dcarry`` of its exit: phase A recomputes the chunk entries
    (device memory), then each chunk from the last one down runs one
    ``steps_vjp`` and one :func:`fold` of its cotangents into ``gacc`` and
    into ``dx_rows`` (one tensor per inexact ``xs`` leaf, the segment's
    rows, written in place); a short tail chunk's parameter cotangent is
    held and added after chunk 0's, in chunk 0's launch, as the TPU kernel
    adds it once at the end (``segment_fused.reverse_walk``).  Returns
    ``(dcarry_at_begin, gacc)``."""
    dc, dp_tail = dcarry, None
    for kk, lo, hi, entry, tail in reverse_walk(body, params, carry_b,
                                                xs_seg, batch, chunk=chunk):
        # each step's input cotangents as autograd makes them: no stacked
        # buffer of the chunk held beside its activations
        dp, dc, dxd = steps_vjp(body, params, entry, _slice(xs_seg, lo, hi),
                                batch, xs_mask, dc, split_xs=True)
        del entry
        dps = [dp]
        if tail:
            # its rows now, its cotangent after chunk 0's in one launch
            dp_tail, dps = dp, []
        elif kk == 0 and dp_tail is not None:
            dps.append(dp_tail)
        gacc = fold(gacc, dps,
                    [r[k] for r in dx_rows for k in range(lo, hi)],
                    [g for steps in dxd for g in steps])
        del dp, dps, dxd
    return dc, gacc


def dx_buffers(xs, xs_mask) -> List[torch.Tensor]:
    """Zeroed full-length input-cotangent buffers, one per inexact ``xs``
    leaf (the layout of ``CompiledSegmentRunner.dx_full``)."""
    return [leaf.new_zeros(leaf.shape)
            for leaf, m in zip(pytree.tree_leaves(xs), xs_mask) if m]


def reverse_segment(body, xs_mask, params, carry_b, xs_seg, batch, dcarry,
                    *, chunk: int) -> Tuple[Any, Any, List[torch.Tensor]]:
    """:func:`reverse` from an empty accumulator into buffers of its own:
    ``(dcarry_at_begin, dparams, dxd)``, the segment wrappers' contract."""
    dxd = dx_buffers(xs_seg, xs_mask)
    dc, dp = reverse(body, xs_mask, params, carry_b, xs_seg, batch, dcarry,
                     zero_grads(params), dxd, chunk=chunk)
    return dc, dp, dxd

