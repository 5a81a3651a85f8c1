# Port of repro/core/compiled_ops.py: CompiledChainOps,
# CompiledSegmentRunner and the fused runner (PallasSegmentRunner there).
"""Per-segment chain operators and the segment runners built on them.

* :class:`CompiledChainOps` — the plain PyTorch segment ops:
  ``advance_segment`` steps the body over the interval; ``reverse_segment``
  is one autograd pass over the segment, recomputed under
  ``torch.utils.checkpoint`` at :func:`chunk_length` granularity with the
  JAX runner's ``divmod`` full-chunk/tail layout (``compiled_ops.py:142-162``
  there).
* :class:`CompiledSegmentRunner` — one call per segment (O(n/I) host
  dispatches); the counterpart of XLA's ``runner="compiled"``.
* :class:`FusedSegmentRunner` — ``runner="fused"``, the JAX package's
  ``runner="pallas"``: the hand-written CUDA segment kernels of
  :mod:`repro_torch.kernels.segment_fused`, with the same counters.

``ParamStreamSegmentRunner`` and the 2D planner's ``inner_chunked_body``
come later (ROADMAP queue 1, items 12 and 11).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.api.chain import chain_length, steps_vjp
from repro_torch.core.schedule import SegmentSpec, chunk_length
from repro_torch.core.storage import HostTree
from repro_torch.kernels import segment_fused

__all__ = ["CompiledChainOps", "CompiledSegmentRunner", "FusedSegmentRunner",
           "chunk_length"]

tree_map = pytree.tree_map


class CompiledChainOps:
    """Per-segment advance/reverse for one chain body.

    ``body(params, carry, x, batch) -> carry`` is one chain step (the
    :class:`~repro_torch.api.chain.ChainSpec` contract); ``xs_mask`` is the
    per-leaf inexact (differentiable) mask of the per-step inputs.
    """

    def __init__(self, body, xs_treespec, xs_mask: Tuple[bool, ...]):
        self.body = body
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
        dp, dc, dxd = steps_vjp(self.body, params, carry_b, xs_seg, batch,
                                self.xs_mask, dcarry,
                                chunk=chunk_length(seg_len, s_l1))
        # in place: the accumulator is the executor's own (a model's
        # parameters can be gigabytes)
        for acc, g in zip(pytree.tree_leaves(gacc), pytree.tree_leaves(dp)):
            acc.add_(g)
        return dc, gacc, dxd


class CompiledSegmentRunner:
    """Executor plug-in: one call per segment (O(n/I) host dispatches).

    The adjoint is the front-end's ``(dcarry, param_grad_accum)`` pair; the
    per-step input cotangents land in ``dx_segments`` keyed by segment begin
    (the caller stitches them back together after the sweep).
    """

    def __init__(self, ops: CompiledChainOps, params, xs, batch, *,
                 s_l1: int):
        self.ops = ops
        self.params = params
        self.xs = xs
        self.batch = batch
        self.s_l1 = s_l1
        self.dx_segments: Dict[int, List[Any]] = {}

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
        self.dx_segments[seg.begin] = dxd
        # logical advance accounting: the vjp replays the segment once while
        # linearising, and chunked checkpointing rematerialises each chunk
        # interior once more during the backward
        replay = seg.length
        if chunk_length(seg.length, self.s_l1) is not None:
            replay += seg.length
        stats.advances += replay
        stats.backwards += seg.length
        stats.host_dispatches += 1
        return dc, gacc

    def collect_dx(self, plan) -> List[Any]:
        """Stitch per-segment input cotangents back into full-chain arrays
        (one stacked tensor per inexact xs leaf, step axis leading)."""
        begins = [seg.begin for seg in plan.segments]
        if not begins or not self.dx_segments:
            return []
        num_leaves = len(self.dx_segments[begins[0]])
        return [torch.cat([self.dx_segments[b][i] for b in begins])
                for i in range(num_leaves)]


class FusedSegmentRunner(CompiledSegmentRunner):
    """``runner="fused"``: the fused segment kernels
    (:mod:`repro_torch.kernels.segment_fused`).

    Same executor protocol as :class:`CompiledSegmentRunner`, plus
    :meth:`advance_with_store`: the segment-entry boundary comes *out of the
    kernel* — already written to page-locked host memory while the segment
    computed — instead of being snapshotted before the advance.  On CPU
    tensors the kernels' plain versions run (any body); on the card only the
    registered bodies (the LSTM chain step) run, others raise.
    """

    def __init__(self, ops: CompiledChainOps, params, xs, batch, *,
                 s_l1: int):
        # contiguous per-step inputs: each segment slice is then contiguous
        xs = tree_map(lambda leaf: leaf.contiguous(), xs)
        super().__init__(ops, params, xs, batch, s_l1=s_l1)

    def _chunk(self, seg: SegmentSpec) -> int:
        # the reverse chunks like the compiled runner's checkpointed vjp;
        # the forward shares the layout so one boundary stream serves both
        return chunk_length(seg.length, self.s_l1) or seg.length

    def _advance_fused(self, state, seg: SegmentSpec, stats):
        out = segment_fused.fused_advance_segment(
            self.ops.body, self.params, state, self._slice(seg), self.batch,
            chunk=self._chunk(seg))
        stats.advances += seg.length
        stats.host_dispatches += 1
        stats.fused_segments += 1
        stats.fused_boundary_copies += int(
            pytree.tree_leaves(out.boundaries)[0].shape[0])
        return out

    def advance(self, state, seg: SegmentSpec, stats):
        return self._advance_fused(state, seg, stats).carry

    def advance_with_store(self, state, seg: SegmentSpec, stats):
        """Advance one segment and return ``(new_state, entry_boundary)``:
        the kernel's ``boundaries[0]`` as a :class:`HostTree` fenced by the
        kernel's event — the Level-2 store takes those buffers as they are."""
        out = self._advance_fused(state, seg, stats)
        bnd0 = tree_map(lambda leaf: leaf[0], out.boundaries)
        return out.carry, HostTree(bnd0, out.ready)

    def reverse(self, x_b, adjoint, seg: SegmentSpec, slots, stats):
        dcarry, gacc = adjoint
        dc, dp, dxd = segment_fused.fused_reverse_segment(
            self.ops.body, self.ops.xs_mask, self.params, x_b,
            self._slice(seg), self.batch, dcarry, chunk=self._chunk(seg))
        gacc = tree_map(torch.add, gacc, dp)
        self.dx_segments[seg.begin] = dxd
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
