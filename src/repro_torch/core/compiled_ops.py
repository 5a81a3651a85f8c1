# Port of repro/core/compiled_ops.py: inner_chunked_body, CompiledChainOps,
# CompiledSegmentRunner, ParamStreamSegmentRunner and the fused runner
# (PallasSegmentRunner there).
"""Per-segment chain operators and the segment runners built on them.

* :class:`CompiledChainOps` — the plain PyTorch segment ops:
  ``advance_segment`` steps the body over the interval; ``reverse_segment``
  is one autograd pass over the segment, recomputed under
  ``torch.utils.checkpoint`` at :func:`chunk_length` granularity with the
  JAX runner's ``divmod`` full-chunk/tail layout (``compiled_ops.py:142-162``
  there).
* :class:`CompiledSegmentRunner` — one call per segment (O(n/I) host
  dispatches); the counterpart of XLA's ``runner="compiled"``.
* :class:`ParamStreamSegmentRunner` — the compiled runner whose streamed
  ``xs`` leaves (a MoE chain's experts, ``offload_params=``) come from the
  parameter lane of Level 2 (``executor.ParamStream``).
* :class:`FusedSegmentRunner` — ``runner="fused"``, the JAX package's
  ``runner="pallas"``: the hand-written CUDA segment kernels of
  :mod:`repro_torch.kernels.segment_fused` (the LSTM chain step), and for
  any other body its own PyTorch code with the copy and fold kernels of
  :mod:`repro_torch.kernels.segment_generic`, with the same counters.
* :func:`inner_chunked_body` — the reverse body of a 2D plan: one step's
  layers in the plan's inner sub-ranges, each under
  ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.api.chain import (accumulate, chain_length,
                                   is_broadcast_zero, steps_vjp)
from repro_torch.core.schedule import InnerPlan, SegmentSpec, chunk_length
from repro_torch.core.storage import HostTree, tree_bytes
from repro_torch.kernels import segment_fused

__all__ = ["CompiledChainOps", "CompiledSegmentRunner", "FusedSegmentRunner",
           "ParamStreamSegmentRunner", "chunk_length", "inner_chunked_body"]

tree_map = pytree.tree_map


def inner_chunked_body(layer_body, inner: InnerPlan):
    """A chain-step body that applies the step's layer stack in the 2D
    plan's inner sub-ranges, each under ``torch.utils.checkpoint``
    (non-reentrant, so it nests inside the segment's chunk checkpoints).

    ``layer_body(params, carry, x, batch, j)`` is the
    :class:`~repro_torch.api.chain.ChainSpec` per-layer contract; composing
    ``j = 0 .. n_layers-1`` equals one plain ``body`` application, so the
    returned function computes what the 1D body computes: under autograd
    only the ``layer_chunks`` sub-range entry states of a step are saved,
    and each chunk's interior is recomputed once when the step is
    backwarded.
    """
    ranges = inner.chunk_ranges()

    def body(params, carry, x, batch):
        for lo, hi in ranges:
            def chunk_fn(p, c, x_, lo=lo, hi=hi):
                for j in range(lo, hi):
                    c = layer_body(p, c, x_, batch, j)
                return c

            carry = checkpoint(chunk_fn, params, carry, x,
                               use_reentrant=False)
        return carry

    return body


class CompiledChainOps:
    """Per-segment advance/reverse for one chain body.

    ``body(params, carry, x, batch) -> carry`` is one chain step (the
    :class:`~repro_torch.api.chain.ChainSpec` contract); ``xs_mask`` is the
    per-leaf inexact (differentiable) mask of the per-step inputs.  A 2D
    plan reverses through ``reverse_body`` (:func:`inner_chunked_body`),
    which computes what ``body`` computes; the advance keeps ``body``.
    """

    def __init__(self, body, xs_treespec, xs_mask: Tuple[bool, ...],
                 reverse_body=None):
        self.body = body
        self.reverse_body = body if reverse_body is None else reverse_body
        self.xs_treespec = xs_treespec
        self.xs_mask = tuple(xs_mask)

    def advance_segment(self, params, carry, xs_seg, batch):
        """carry -> carry over one segment."""
        with torch.no_grad():
            for k in range(chain_length(xs_seg)):
                x = tree_map(lambda leaf: leaf[k], xs_seg)
                carry = self.body(params, carry, x, batch)
        return carry

    def reverse_segment(self, params, carry_b, xs_seg, batch, dcarry, gacc,
                        *, s_l1: int):
        """Reverse one segment from its Level-2 boundary state in one call.

        Returns ``(dcarry_at_begin, gacc + segment param grads,
        dxs_diff_leaves)`` — the cotangents of the segment's inexact
        per-step inputs, stacked along the step axis.
        """
        seg_len = chain_length(xs_seg)
        dp, dc, dxd = steps_vjp(self.reverse_body, params, carry_b, xs_seg,
                                batch, self.xs_mask, dcarry,
                                chunk=chunk_length(seg_len, s_l1))
        # in place: the accumulator is the executor's own (a model's
        # parameters can be gigabytes)
        return dc, accumulate(gacc, dp), dxd


class CompiledSegmentRunner:
    """Executor plug-in: one call per segment (O(n/I) host dispatches).

    The adjoint is the front-end's ``(dcarry, param_grad_accum)`` pair; each
    reversed segment writes its per-step input cotangents into full-chain
    arrays (``dx_full``, one per inexact xs leaf, step axis leading,
    allocated at the first segment), so they are never held twice.
    """

    def __init__(self, ops: CompiledChainOps, params, xs, batch, *,
                 s_l1: int, n: Optional[int] = None,
                 inner: Optional[InnerPlan] = None):
        self.ops = ops
        self.params = params
        self.xs = xs
        self.batch = batch
        self.s_l1 = s_l1
        self.n = chain_length(xs) if n is None else n
        self.inner = inner
        self.dx_full: Optional[List[torch.Tensor]] = None

    def _slice(self, seg: SegmentSpec):
        return tree_map(lambda leaf: leaf[seg.begin:seg.end], self.xs)

    def advance(self, state, seg: SegmentSpec, stats):
        state = self.ops.advance_segment(self.params, state,
                                         self._slice(seg), self.batch)
        stats.advances += seg.length
        stats.host_dispatches += 1
        return state

    def reverse(self, x_b, adjoint, seg: SegmentSpec, slots, stats):
        dcarry, gacc = adjoint
        dc, gacc, dxd = self.ops.reverse_segment(
            self.params, x_b, self._slice(seg), self.batch, dcarry, gacc,
            s_l1=self.s_l1)
        self.keep_dx(seg.begin, dxd)
        # logical advance accounting: the vjp replays the segment once while
        # linearising, and chunked checkpointing rematerialises each chunk
        # interior once more during the backward
        replay = seg.length
        if chunk_length(seg.length, self.s_l1) is not None:
            replay += seg.length
        stats.advances += replay
        stats.backwards += seg.length
        stats.host_dispatches += 1
        if self.inner is not None:
            # inner-axis accounting: each backwarded step recomputes its
            # whole layer stack once, saving layer_chunks sub-range entry
            # states (each the carry's pytree, measured on the boundary)
            stats.inner_recomputed_layers += \
                seg.length * self.inner.n_layers
            bnd = self.inner.layer_chunks * tree_bytes(x_b)
            stats.inner_peak_bytes = max(stats.inner_peak_bytes, bnd)
        return dc, gacc

    def keep_dx(self, begin: int, dxd) -> None:
        """Write one segment's stacked input cotangents (from its reverse,
        or read back from a journal) into ``dx_full``."""
        if self.dx_full is None:
            self.dx_full = [d.new_zeros((self.n, *d.shape[1:])) for d in dxd]
        for full, d in zip(self.dx_full, dxd):
            full[begin:begin + d.shape[0]].copy_(d)

    def dx_of(self, seg: SegmentSpec) -> Optional[List[torch.Tensor]]:
        """The segment's part of ``dx_full`` (views), once it is reversed."""
        if self.dx_full is None:
            return None
        return [full[seg.begin:seg.end] for full in self.dx_full]

    def collect_dx(self) -> List[Any]:
        """The full-chain input cotangents (one stacked tensor per inexact
        xs leaf, step axis leading)."""
        return self.dx_full or []


class ParamStreamSegmentRunner(CompiledSegmentRunner):
    """Compiled segment runner whose streamed ``xs`` leaves come from
    Level 2.

    ``stream`` is an :class:`~repro_torch.core.executor.ParamStream`;
    ``xs`` holds 0-d placeholders at the streamed flat positions (the tree
    keeps its structure) and ``n`` is the chain's length.  ``_slice``
    assembles the streamed leaves' segment slices from the prefetched
    blobs on the run's device and slices the resident leaves as usual, so
    the tensors entering ``advance_segment``/``reverse_segment`` hold the
    same values, shapes and layout as the unstreamed runner's: gradients
    are bit for bit the same.  The streamed leaves' gradients land in
    ``dx_full`` on the run's device, as every ``xs`` leaf's does.
    """

    def __init__(self, ops: CompiledChainOps, params, xs, batch, *,
                 s_l1: int, stream, n: int,
                 inner: Optional[InnerPlan] = None):
        super().__init__(ops, params, xs, batch, s_l1=s_l1, n=n,
                         inner=inner)
        self.stream = stream
        self._leaves, self._spec = pytree.tree_flatten(xs)

    def _slice(self, seg: SegmentSpec):
        streamed = self.stream.leaf_ids
        out = [self.stream.gather(i, seg) if i in streamed
               else leaf[seg.begin:seg.end]
               for i, leaf in enumerate(self._leaves)]
        return pytree.tree_unflatten(out, self._spec)


class FusedSegmentRunner(CompiledSegmentRunner):
    """``runner="fused"``: the fused segments
    (:mod:`repro_torch.kernels.segment_fused`, and for any body other than
    the LSTM chain step :mod:`repro_torch.kernels.segment_generic`).

    Same executor protocol as :class:`CompiledSegmentRunner`, plus
    :meth:`advance_with_store`: the segment-entry boundary comes *out of the
    segment* — already written to page-locked host memory while the segment
    computed — instead of being snapshotted before the advance.  What runs
    where:

    * the LSTM chain step on the card: the hand-written LSTM segment
      kernels, every segment one replay of a captured CUDA graph per
      direction (:class:`~repro_torch.kernels.segment_fused.CapturedRun`,
      the counterpart of the JAX runner's jit cache): boundaries go into
      pooled page-locked slots (the pool grows to the run's need in its
      first call), and the reverse adds each segment's gradient into one
      flat accumulator in place.  The counters are those of the uncaptured
      run.  On CPU tensors the kernels' plain versions run.
    * any other body (on the card or not, uncaptured): the body's steps and
      their vjp as the caller's PyTorch code on the compute stream, as
      :class:`CompiledSegmentRunner` runs them; each chunk entry goes to
      host slots by the ``entry_store`` kernel on a side stream while the
      chunk computes (the segment entry into a slot of its own, the later
      ones into the pool's scratch pair), and each reverse chunk's
      cotangents go by one
      ``fold`` launch into the executor's own accumulator (in place) and
      into ``dx_full``'s rows.  On CPU tensors those two run their plain
      versions.
    """

    def __init__(self, ops: CompiledChainOps, params, xs, batch, *,
                 s_l1: int):
        # contiguous per-step inputs: each segment slice is then contiguous
        xs = tree_map(lambda leaf: leaf.contiguous(), xs)
        super().__init__(ops, params, xs, batch, s_l1=s_l1)
        self.n = chain_length(xs)
        self._card = not segment_fused._on_cpu(params)
        self._generic = segment_fused.body_kind(ops.body) == \
            segment_fused.GENERIC
        self._captured = None   # the CapturedRun, at first use
        self._flat = None       # the card's gradient accumulator, flat
        self._gtree = None      # ... as the parameter tree (views)

    def _capture_run(self):
        if not (self._card and segment_fused._CAPTURED) or self._generic:
            return None
        if self._captured is None:
            self._captured = segment_fused.CapturedRun(
                self.ops.body, self.params, self.xs)
        return self._captured

    def _chunk(self, seg: SegmentSpec) -> int:
        # the reverse chunks like the compiled runner's checkpointed vjp;
        # the forward shares the layout so one boundary stream serves both
        return chunk_length(seg.length, self.s_l1) or seg.length

    def _advance_fused(self, state, seg: SegmentSpec, stats):
        cap = self._capture_run()
        if cap is not None:
            out = cap.advance(state, seg.begin, seg.length, self._chunk(seg),
                              last=seg.end == self.n)
        else:
            out = segment_fused.fused_advance_segment(
                self.ops.body, self.params, state, self._slice(seg),
                self.batch, chunk=self._chunk(seg))
        stats.advances += seg.length
        stats.host_dispatches += 1
        stats.fused_segments += 1
        stats.fused_boundary_copies += len(out.entries)
        return out

    def advance(self, state, seg: SegmentSpec, stats):
        return self._advance_fused(state, seg, stats).carry

    def advance_with_store(self, state, seg: SegmentSpec, stats):
        """Advance one segment and return ``(new_state, entry_boundary)``:
        the segment's ``entries[0]`` as a :class:`HostTree` fenced by its
        event — the Level-2 store takes those buffers as they are (each
        owns its storage)."""
        out = self._advance_fused(state, seg, stats)
        return out.carry, HostTree(out.entries[0], out.ready)

    def _accumulate(self, gacc, gflat):
        """The LSTM card path's ``gacc + gflat`` into the run's flat
        accumulator, in place: the first segment (or a tree from
        elsewhere, such as a journal's cursor) starts it."""
        if gacc is not self._gtree:
            self._flat = torch.zeros_like(gflat)
            self._gtree = segment_fused._grad_views(
                self._flat, _lstm_dims(self.params, self.xs))
            for k, g in gacc.items():
                if not is_broadcast_zero(g):
                    self._gtree[k].copy_(g)
        self._flat.add_(gflat)
        return self._gtree

    def _reverse_generic(self, x_b, dcarry, gacc, seg: SegmentSpec):
        """A generic body's reverse: the chunks' cotangents folded into
        ``gacc`` and written into ``dx_full``'s rows of the segment."""
        from repro_torch.kernels import segment_generic

        if self.dx_full is None:
            self.dx_full = segment_generic.dx_buffers(self.xs,
                                                      self.ops.xs_mask)
        rows = [full[seg.begin:seg.end] for full in self.dx_full]
        return segment_generic.reverse(
            self.ops.body, self.ops.xs_mask, self.params, x_b,
            self._slice(seg), self.batch, dcarry, gacc, rows,
            chunk=self._chunk(seg))

    def reverse(self, x_b, adjoint, seg: SegmentSpec, slots, stats):
        dcarry, gacc = adjoint
        if self._generic:
            dc, gacc = self._reverse_generic(x_b, dcarry, gacc, seg)
        elif not self._card:
            dc, dp, dxd = segment_fused.fused_reverse_segment(
                self.ops.body, self.ops.xs_mask, self.params, x_b,
                self._slice(seg), self.batch, dcarry,
                chunk=self._chunk(seg))
            gacc = tree_map(torch.add, gacc, dp)
            self.keep_dx(seg.begin, dxd)
        else:
            cap = self._capture_run()
            if cap is not None:
                dc, gflat = cap.reverse(x_b, dcarry, seg.begin, seg.length,
                                        self._chunk(seg),
                                        last=seg.begin == 0)
            else:
                dc, gflat = segment_fused._fused_reverse_card(
                    self.ops.body, self.params, x_b, self._slice(seg),
                    dcarry, chunk=self._chunk(seg))
            gacc = self._accumulate(gacc, gflat)
            self.keep_dx(seg.begin, [])   # token ids: no input cotangents
        # same logical accounting as the compiled runner
        replay = seg.length
        if chunk_length(seg.length, self.s_l1) is not None:
            replay += seg.length
        stats.advances += replay
        stats.backwards += seg.length
        stats.host_dispatches += 1
        stats.fused_segments += 1
        nc = -(-seg.length // self._chunk(seg))
        stats.fused_boundary_copies += 2 * nc  # spill out + read back in
        return dc, gacc


def _lstm_dims(params, xs):
    """``(V, Dx, Dh, B)`` of the LSTM chain's parameters and inputs."""
    V, Dx = params["emb"].shape
    return V, Dx, params["w_out"].shape[0], xs[0].shape[1]
