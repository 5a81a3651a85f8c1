# Port of repro/core/executor.py: ExecutionStats, _L1Slots, MultistageRun
# and the multistage sweeps of CheckpointExecutor.
"""Checkpoint execution engine (the paper's §4) — the *execute* stage of the
plan -> compile -> execute pipeline.

The multistage strategy is a thin loop over the
:class:`~repro_torch.core.schedule.SegmentPlan` IR: it interleaves
``AsyncTransferEngine`` store/prefetch events with per-segment work
delegated to a pluggable **segment runner**
(:mod:`repro_torch.core.compiled_ops`):

* ``CompiledSegmentRunner`` — one plain PyTorch call per segment;
* ``FusedSegmentRunner`` — the hand-written CUDA segment kernels: the
  segment-entry boundary comes *out of the kernel*, already written to
  page-locked host memory (``advance_with_store``), and the reverse fuses
  recompute and transpose Echo-style.

The interpreted runner and the Revolve/conventional strategies (ROADMAP
queue 1, item 4), journal/resume (item 8), ``ParamStream`` (item 12) and
tiered ``set_plan`` (item 9) are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from torch.utils import _pytree as pytree

from repro_torch.core import schedule as ms
from repro_torch.core.schedule import SegmentPlan
from repro_torch.core.storage import AsyncTransferEngine, RAMStorage, tree_bytes


@dataclass
class ExecutionStats:
    n: int = 0
    advances: int = 0
    backwards: int = 0
    replayed_advances: int = 0   # resume: re-executed forward steps (<= I)
    host_dispatches: int = 0     # Python-level op/segment invocations
    peak_l1_states: int = 0
    peak_l1_bytes: int = 0
    l2_stores: int = 0
    l2_prefetches: int = 0
    l2_peak_bytes: int = 0       # high-water Level-2 (host) footprint
    l2_staged_peak_bytes: int = 0  # engine prefetch staging high-water mark
    prefetch_depth: int = 1      # segments of prefetch lead in the reverse
    fused_segments: int = 0      # fused runner: segments run as fused kernels
    fused_boundary_copies: int = 0  # fused runner: boundary copies made by
    #                                 the kernels (host stream + spill)
    store_stall_s: float = 0.0
    prefetch_stall_s: float = 0.0
    wall_s: float = 0.0

    @property
    def recompute_factor(self) -> float:
        return self.advances / max(1, self.n - 1)


class _L1Slots:
    """Level-1 live-byte accounting: the running state plus the staged
    prefetch.  (The interpreted runner's Revolve snapshot slots come with
    it, ROADMAP queue 1, item 4.)"""

    def __init__(self, stats: ExecutionStats):
        self._stats = stats

    def note_extra(self, nbytes: int) -> None:
        self._stats.peak_l1_bytes = max(self._stats.peak_l1_bytes, nbytes)


@dataclass
class MultistageRun:
    """In-flight state of a split forward/reverse multistage execution.

    Produced by :meth:`CheckpointExecutor.multistage_forward`; consumed by
    :meth:`CheckpointExecutor.multistage_reverse`.  Holds the engine with the
    (possibly still in-flight) Level-2 boundary stores, so the reverse sweep
    can start from Level 2 alone — no Level-1 state survives between phases.
    """

    n: int
    interval: int
    s_l1: int
    engine: AsyncTransferEngine
    stats: ExecutionStats
    slots: "_L1Slots"
    plan: SegmentPlan
    runner: Any = None
    own_engine: bool = True
    closed: bool = False

    def close(self) -> None:
        """Release this run's Level-2 state (idempotent): purge its
        boundary keys and close the engine when this run owns it.
        ``engine.close()`` re-raises pending transfer errors."""
        if self.closed:
            return
        self.closed = True
        try:
            for seg in self.plan.segments:
                try:
                    self.engine.delete(seg.begin)
                except Exception:
                    pass
        finally:
            if self.own_engine:
                self.engine.close()


class CheckpointExecutor:
    """Drives a segment runner through the multistage plan."""

    def multistage_forward(self, state0: Any, n: int, *, interval: int,
                           s_l1: int, runner: Any,
                           engine: "AsyncTransferEngine | None" = None,
                           ) -> "tuple[Any, MultistageRun]":
        """Phase 1: advance the chain to ``x_n`` while the engine
        asynchronously streams every ``interval``-th state to Level 2.
        Returns ``(x_n, run)``; hand ``run`` to :meth:`multistage_reverse`
        (or call ``run.close()`` to abandon it)."""
        if runner is None:
            raise NotImplementedError(
                "the interpreted segment runner is not ported yet (ROADMAP "
                "queue 1, item 4); pass a compiled or fused runner")
        own_engine = engine is None
        if engine is None:
            # prefetched boundaries come back where the chain runs
            engine = AsyncTransferEngine(
                RAMStorage(), device=pytree.tree_leaves(state0)[0].device)
        stats = ExecutionStats(n=n)
        slots = _L1Slots(stats)
        plan = ms.segment_plan(n, interval, s_l1)
        run = MultistageRun(n=n, interval=interval, s_l1=s_l1, engine=engine,
                            stats=stats, slots=slots, plan=plan,
                            runner=runner, own_engine=own_engine)
        t0 = time.perf_counter()
        try:
            current = state0
            # Fused runners produce the segment-entry boundary *from the
            # kernel* (already in page-locked host memory), so the store is
            # enqueued after the advance with the kernel's boundary instead
            # of snapshotting `current` before it.
            aws = getattr(runner, "advance_with_store", None)
            for seg in plan.segments:
                if aws is not None:
                    current, boundary = aws(current, seg, stats)
                    engine.store_async(seg.begin, boundary)
                else:
                    engine.store_async(seg.begin, current)
                    current = runner.advance(current, seg, stats)
                slots.note_extra(tree_bytes(current))
        except BaseException:
            try:  # don't leak the writer thread / Level-2 states; don't
                run.close()  # let cleanup errors mask the original one
            except Exception:
                pass
            raise
        stats.l2_stores = engine.num_stores
        stats.wall_s += time.perf_counter() - t0
        return current, run

    def multistage_reverse(self, run: "MultistageRun", adjoint0: Any):
        """Phase 2: join outstanding stores, then reverse the chain segment
        by segment with Level-2 boundaries prefetched one segment ahead
        (double-buffering, the paper's schedule) and per-segment work
        delegated to the run's segment runner.  Returns ``(adjoint,
        stats)`` and closes the engine if this run owns it."""
        engine, stats, slots = run.engine, run.stats, run.slots
        runner = run.runner
        segs = run.plan.segments
        t0 = time.perf_counter()
        try:
            adjoint = adjoint0
            engine.wait_stores()
            depth = 1
            stats.prefetch_depth = depth
            j_start = len(segs) - 1
            for idx in range(j_start, max(j_start - depth, -1), -1):
                engine.prefetch_async(segs[idx].begin)
            for j in range(j_start, -1, -1):
                seg = segs[j]
                if j - depth >= 0:
                    engine.prefetch_async(segs[j - depth].begin)
                x_b = engine.wait_prefetch(seg.begin)
                slots.note_extra(tree_bytes(x_b))
                adjoint = runner.reverse(x_b, adjoint, seg, slots, stats)
                engine.delete(seg.begin)
            stats.l2_stores = engine.num_stores
            stats.l2_prefetches = engine.num_prefetches
            stats.l2_peak_bytes = getattr(engine.backend, "peak_bytes", 0)
            stats.l2_staged_peak_bytes = engine.staged_peak_bytes
            stats.store_stall_s = engine.store_stall_s
            stats.prefetch_stall_s = engine.prefetch_stall_s
        except BaseException:
            try:
                run.close()
            except Exception:
                pass
            raise
        run.close()
        stats.wall_s += time.perf_counter() - t0
        return adjoint, stats

    def run_multistage(self, state0: Any, n: int, adjoint0: Any, *,
                       interval: int, s_l1: int, runner: Any,
                       engine: "AsyncTransferEngine | None" = None,
                       final_hook=None):
        """The paper's asynchronous multistage strategy (single-shot form:
        forward phase, optional loss/adjoint seeding hook on ``x_n``,
        reverse phase).  Returns (adjoint, stats)."""
        x_n, run = self.multistage_forward(state0, n, interval=interval,
                                           s_l1=s_l1, engine=engine,
                                           runner=runner)
        if final_hook is not None:
            try:
                adjoint0 = final_hook(x_n)
            except BaseException:
                try:
                    run.close()
                except Exception:
                    pass
                raise
        return self.multistage_reverse(run, adjoint0)
