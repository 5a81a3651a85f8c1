# Port of repro/core/executor.py: ExecutionStats, _L1Slots, _exec_revolve,
# InterpretedSegmentRunner, MultistageRun and CheckpointExecutor's
# conventional, Revolve and multistage strategies.
"""Checkpoint execution engine (the paper's §4) — the *execute* stage of the
plan -> compile -> execute pipeline.

The executor drives a *forward operator* and a *backward operator* through a
checkpointing schedule: the caller supplies the two operators plus an
initial state, and the executor owns when states are computed, snapshotted,
offloaded, prefetched and freed::

    state_{k+1} = forward_op(state_k, k)            # k in [0, n)
    adjoint     = backward_op(state_k, adjoint, k)  # reverse of step k,
                                                    # consumes x_k

Three strategies:

* ``run_conventional`` — store every state (peak Level-1 memory grows
  linearly in ``n``);
* ``run_revolve`` — classic single-stage Revolve with ``s`` Level-1 slots
  (recompute factor grows ~log n);
* ``run_multistage`` — the paper's contribution: asynchronous Level-2
  stores every ``interval`` steps and prefetch during the reverse sweep;
  Revolve only *inside* intervals (recompute factor constant in ``n``).

The multistage strategy is a thin loop over the
:class:`~repro_torch.core.schedule.SegmentPlan` IR: it interleaves
``AsyncTransferEngine`` store/prefetch events with per-segment work
delegated to a pluggable **segment runner**:

* :class:`InterpretedSegmentRunner` (``runner=None``) — walks the segment
  step by step through ``forward_op``/``backward_op`` (O(n) host
  dispatches; the paper-faithful interpreter, exact Revolve advance counts);
* ``CompiledSegmentRunner`` (:mod:`repro_torch.core.compiled_ops`) — one
  plain PyTorch call per segment;
* ``FusedSegmentRunner`` — the hand-written CUDA segment kernels: the
  segment-entry boundary comes *out of the kernel*, already written to
  page-locked host memory (``advance_with_store``), and the reverse fuses
  recompute and transpose Echo-style.

A plan-aware Level-2 backend (``TieredStorage``) gets the plan before the
forward sweep (``set_plan``: Belady eviction) and sets the reverse's
prefetch depth (``plan_prefetch_distance``).  Journal/resume (ROADMAP queue
1, item 8) and ``ParamStream`` (item 12) are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from torch.utils import _pytree as pytree

from repro_torch.core import revolve as rv
from repro_torch.core import schedule as ms
from repro_torch.core.revolve import Op
from repro_torch.core.schedule import SegmentPlan, SegmentSpec
from repro_torch.core.storage import AsyncTransferEngine, RAMStorage, tree_bytes

ForwardOp = Callable[[Any, int], Any]
BackwardOp = Callable[[Any, Any, int], Any]


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
    l2_fast_peak_bytes: int = 0  # tiered backend: fast-tier high-water mark
    l2_evictions: int = 0        # tiered backend: fast -> slow spills
    l2_promotions: int = 0       # tiered backend: slow -> fast promotions
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
    """Level-1 snapshot slots with live-byte accounting.  The slots' bytes
    are kept as a running total, so a store costs O(1) however many slots
    are live (store-all keeps ``n``)."""

    def __init__(self, stats: ExecutionStats):
        self._slots: Dict[int, Any] = {}
        self._bytes: Dict[int, int] = {}
        self._total = 0        # bytes of the stored slots
        self._stats = stats
        self._extra_bytes = 0  # running state + staged prefetch

    def _update_peak(self) -> None:
        n_states = len(self._slots)
        self._stats.peak_l1_states = max(self._stats.peak_l1_states, n_states)
        self._stats.peak_l1_bytes = max(
            self._stats.peak_l1_bytes, self._total + self._extra_bytes)

    def note_extra(self, nbytes: int) -> None:
        self._extra_bytes = nbytes
        self._update_peak()

    def store(self, idx: int, state: Any) -> None:
        self.free(idx)
        self._slots[idx] = state
        self._bytes[idx] = tree_bytes(state)
        self._total += self._bytes[idx]
        self._update_peak()

    def restore(self, idx: int) -> Any:
        return self._slots[idx]

    def free(self, idx: int) -> None:
        self._slots.pop(idx, None)
        self._total -= self._bytes.pop(idx, 0)

    def __contains__(self, idx: int) -> bool:
        return idx in self._slots

    def __len__(self) -> int:
        return len(self._slots)


def _exec_revolve(forward_op: ForwardOp, backward_op: BackwardOp, sched,
                  slots: _L1Slots, adjoint: Any,
                  stats: ExecutionStats) -> Any:
    """Interpret a Revolve action stream (the single-stage strategy and the
    Revolve-inside-an-interval sub-plans)."""
    current: Any = None
    current_idx = -1
    for a in sched:
        if a.op is Op.RESTORE:
            current = slots.restore(a.index)
            current_idx = a.index
        elif a.op is Op.ADVANCE:
            assert current_idx == a.index, (current_idx, a)
            for k in range(a.index, a.end):
                current = forward_op(current, k)
                stats.advances += 1
                stats.host_dispatches += 1
            current_idx = a.end
        elif a.op is Op.STORE:
            assert current_idx == a.index, (current_idx, a)
            slots.store(a.index, current)
        elif a.op is Op.FREE:
            slots.free(a.index)
        elif a.op is Op.BACKWARD:
            assert current_idx == a.index, (current_idx, a)
            adjoint = backward_op(current, adjoint, a.index)
            stats.backwards += 1
            stats.host_dispatches += 1
    return adjoint


class InterpretedSegmentRunner:
    """Step-granular segment runner: the paper-faithful Python interpreter.

    One ``forward_op``/``backward_op`` dispatch per chain step; reversal uses
    the segment's Revolve sub-plan when it does not fit in Level 1, store-all
    replay otherwise.  Advance counts are exactly Revolve-optimal; the host
    dispatch count is O(n).
    """

    def __init__(self, forward_op: ForwardOp,
                 backward_op: Optional[BackwardOp]):
        self.forward_op = forward_op
        self.backward_op = backward_op

    def advance(self, state: Any, seg: SegmentSpec,
                stats: ExecutionStats) -> Any:
        for k in range(seg.begin, seg.end):
            state = self.forward_op(state, k)
            stats.advances += 1
            stats.host_dispatches += 1
        return state

    def reverse(self, x_b: Any, adjoint: Any, seg: SegmentSpec,
                slots: _L1Slots, stats: ExecutionStats) -> Any:
        b, e = seg.begin, seg.end
        if seg.revolve is not None:  # Revolve inside the interval
            slots.store(b, x_b)
            adjoint = _exec_revolve(self.forward_op, self.backward_op,
                                    seg.revolve, slots, adjoint, stats)
            slots.free(b)
            return adjoint
        # Store-all replay: the whole segment fits in Level 1.
        states = {b: x_b}
        current = x_b
        for k in range(b + 1, e):
            current = self.forward_op(current, k - 1)
            stats.advances += 1
            stats.host_dispatches += 1
            states[k] = current
            slots.store(k, current)  # accounting only
        for k in range(e - 1, b - 1, -1):
            adjoint = self.backward_op(states.pop(k), adjoint, k)
            stats.backwards += 1
            stats.host_dispatches += 1
            slots.free(k)
        return adjoint


@dataclass
class MultistageRun:
    """In-flight state of a split forward/reverse multistage execution.

    Produced by :meth:`CheckpointExecutor.multistage_forward`; consumed by
    :meth:`CheckpointExecutor.multistage_reverse`.  Holds the engine with the
    (possibly still in-flight) Level-2 boundary stores, so the reverse sweep
    can start from Level 2 alone — no Level-1 state survives between phases.
    ``runner`` is the segment runner chosen at forward time (``None``: the
    reversing executor builds an interpreted runner from its operators).
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
    """Drives ``forward_op``/``backward_op`` (or a segment runner) through
    a checkpointing strategy."""

    def __init__(self, forward_op: Optional[ForwardOp] = None,
                 backward_op: Optional[BackwardOp] = None):
        self.forward_op = forward_op
        self.backward_op = backward_op

    def _advance(self, state: Any, b: int, e: int,
                 stats: ExecutionStats) -> Any:
        for k in range(b, e):
            state = self.forward_op(state, k)
            stats.advances += 1
            stats.host_dispatches += 1
        return state

    # ------------------------------------------------------------ strategies
    def run_conventional(self, state0: Any, n: int, adjoint0: Any,
                         final_hook: Optional[Callable[[Any], Any]] = None):
        """Store-everything baseline.  Returns (adjoint, stats)."""
        stats = ExecutionStats(n=n)
        slots = _L1Slots(stats)
        t0 = time.perf_counter()
        state = state0
        for k in range(n):
            slots.store(k, state)
            state = self.forward_op(state, k)
            stats.advances += 1
            stats.host_dispatches += 1
        if final_hook is not None:
            adjoint0 = final_hook(state)
        adjoint = adjoint0
        for k in range(n - 1, -1, -1):
            adjoint = self.backward_op(slots.restore(k), adjoint, k)
            stats.backwards += 1
            stats.host_dispatches += 1
            slots.free(k)
        stats.wall_s = time.perf_counter() - t0
        return adjoint, stats

    def run_revolve(self, state0: Any, n: int, adjoint0: Any, s: int,
                    final_hook: Optional[Callable[[Any], Any]] = None):
        """Classic Revolve with ``s`` Level-1 slots.  Returns (adjoint,
        stats).  ``final_hook(x_n)`` (if given) observes the final state —
        e.g. computes the loss and seeds the adjoint — after an initial
        forward sweep; Revolve's own replays then start from its slots."""
        stats = ExecutionStats(n=n)
        slots = _L1Slots(stats)
        t0 = time.perf_counter()
        slots.store(0, state0)
        if final_hook is not None:
            xn = self._advance(state0, 0, n, stats)
            adjoint0 = final_hook(xn)
        sched = rv.revolve_schedule(n, s)
        adjoint = _exec_revolve(self.forward_op, self.backward_op, sched,
                                slots, adjoint0, stats)
        stats.wall_s = time.perf_counter() - t0
        return adjoint, stats

    def multistage_forward(self, state0: Any, n: int, *, interval: int,
                           s_l1: int, runner: Any = None,
                           engine: "AsyncTransferEngine | None" = None,
                           ) -> "tuple[Any, MultistageRun]":
        """Phase 1: advance the chain to ``x_n`` while the engine
        asynchronously streams every ``interval``-th state to Level 2.
        Returns ``(x_n, run)``; hand ``run`` to :meth:`multistage_reverse`
        (or call ``run.close()`` to abandon it).  ``runner=None`` walks the
        segments with an :class:`InterpretedSegmentRunner` over this
        executor's operators (the reversing executor builds its own)."""
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
        fwd_runner = runner if runner is not None else \
            InterpretedSegmentRunner(self.forward_op, self.backward_op)
        # a capacity-bounded backend evicts by the plan's reverse access
        # order: the victim is the boundary needed farthest ahead (Belady)
        set_plan = getattr(engine.backend, "set_plan", None)
        if set_plan is not None:
            set_plan(plan)
        t0 = time.perf_counter()
        try:
            current = state0
            # Fused runners produce the segment-entry boundary *from the
            # kernel* (already in page-locked host memory), so the store is
            # enqueued after the advance with the kernel's boundary instead
            # of snapshotting `current` before it.
            aws = getattr(fwd_runner, "advance_with_store", None)
            for seg in plan.segments:
                if aws is not None:
                    current, boundary = aws(current, seg, stats)
                    engine.store_async(seg.begin, boundary)
                else:
                    engine.store_async(seg.begin, current)
                    current = fwd_runner.advance(current, seg, stats)
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
        runner = run.runner if run.runner is not None else \
            InterpretedSegmentRunner(self.forward_op, self.backward_op)
        segs = run.plan.segments
        t0 = time.perf_counter()
        try:
            adjoint = adjoint0
            engine.wait_stores()
            # prefetch lead: 1 (double-buffer) unless the backend derives a
            # plan-aware distance (the stores above have all landed)
            depth = 1
            hint = getattr(engine.backend, "plan_prefetch_distance", None)
            if hint is not None:
                depth = max(1, int(hint(run.plan)))
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
            backend = engine.backend
            stats.l2_peak_bytes = getattr(backend, "peak_bytes", 0)
            stats.l2_fast_peak_bytes = getattr(backend, "fast_peak_bytes", 0)
            stats.l2_evictions = getattr(backend, "evictions", 0)
            stats.l2_promotions = getattr(backend, "promotions", 0)
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
                       interval: int, s_l1: int, runner: Any = None,
                       engine: "AsyncTransferEngine | None" = None,
                       final_hook: Optional[Callable[[Any], Any]] = None):
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
