# Port of repro/core/executor.py: ExecutionStats, _L1Slots, _exec_revolve,
# InterpretedSegmentRunner, ParamStream, MultistageRun and
# CheckpointExecutor's conventional, Revolve and multistage strategies, with
# the journaled forward/reverse sweeps and their resume (FINAL_STATE_KEY,
# _journal_backend, _exact_get) and the parameter lane (param_stream=).
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
prefetch depth (``plan_prefetch_distance``).  Over a journaled backend
(``JournaledStorage``) both sweeps are crash-consistent and resumable
(``resume_from=``).  A :class:`ParamStream` (``param_stream=``) streams
large per-step parameter blobs (a MoE chain's experts) through the same
Level 2, one segment ahead of the compute in both sweeps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import revolve as rv
from repro_torch.core import schedule as ms
from repro_torch.core.faults import StorageFault
from repro_torch.core.journal import RecoveredRun
from repro_torch.core.revolve import Op
from repro_torch.core.schedule import SegmentPlan, SegmentSpec
from repro_torch.core.storage import (AsyncTransferEngine, RAMStorage,
                                      _frozen_views, _host_tensor,
                                      page_locked_copy, tree_bytes)

__all__ = ["CheckpointExecutor", "ExecutionStats", "FINAL_STATE_KEY",
           "InterpretedSegmentRunner", "MultistageRun", "ParamStream",
           "placed"]

ForwardOp = Callable[[Any, int], Any]
BackwardOp = Callable[[Any, Any, int], Any]

# Journal key of the end-of-chain state x_n: stored by journaled forward
# passes so a crash during the *reverse* sweep can resume without redoing
# the O(n) forward (the loss/readout is recomputed from x_n on resume).
FINAL_STATE_KEY = "__final__"


def _journal_backend(engine: AsyncTransferEngine):
    """The engine's backend if it speaks the journal protocol, else None
    (duck-typed: ``put_cursor`` is the discriminating verb; wrappers like
    ``CompressedStorage`` delegate it to a journaled inner store)."""
    backend = engine.backend
    return backend if hasattr(backend, "put_cursor") else None


def _exact_get(backend, key):
    """Resume state load: prefer the backend's exact (raw-journal) read
    over the normal get, which may round-trip a lossy codec."""
    exact = getattr(backend, "get_exact", None)
    return exact(key) if exact is not None else backend.get(key)


def placed(tree: Any, like: Any) -> Any:
    """A tree read back from Level 2 or the journal (host numpy leaves, a
    bf16 leaf as ``Bits``) as tensors on the device of ``like``'s leaves,
    bit for bit.  A resumed run's restart state, its ``x_n`` and its
    cursor's adjoint come back this way before the runner or the loss
    reads them."""
    dev = pytree.tree_leaves(like)[0].device
    return pytree.tree_map(lambda a: _host_tensor(a).to(dev), tree)


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
    # -- parameter streaming lane (offload_params=, e.g. MoE experts) ------
    param_prefetches: int = 0    # prefetch batches issued (per segment/phase)
    param_fetch_stalls: int = 0  # param waits that actually blocked compute
    param_bytes_moved: int = 0   # bytes fetched through the param lane
    param_stall_s: float = 0.0   # time the sweeps waited for param blobs
    param_populate_s: float = 0.0  # time writing the blobs to Level 2
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


class ParamStream:
    """Streams large per-step parameter blobs (MoE expert weights) through
    Level 2 alongside boundary states: the paper's overlap discipline
    applied to parameters (weight offload under the multistage schedule).

    ``leaves_by_id`` maps a chain-input leaf id (its position among the
    flattened ``xs`` leaves) to a tensor of shape ``(n, n_experts, ...)`` —
    one blob per (step, expert) — wherever the caller keeps it.  Blobs live
    in the engine's backend under
    :func:`~repro_torch.core.schedule.expert_key` keys and share the
    backend's capacity budget with boundary states through merged
    :class:`~repro_torch.core.schedule.ResourceAccessPlan` orders.

    Determinism contract (what makes the perfmodel's fast-tier peak
    exact): :meth:`populate` writes every blob on the caller's thread in
    :meth:`population_order`; after that the only fast-tier writer is the
    engine's one FIFO store thread (boundary states), and every streamed
    read goes through non-promoting ``peek``, so the backend's put
    sequence, its Belady eviction trace and ``fast_peak_bytes`` are
    replayable by ``perfmodel.fast_peak_bytes_resources``.

    ``expert_counts`` (optional ``(n, n_experts)`` routing statistics from
    ``models.moe.routing_stats``) orders experts busiest-first within each
    step, so the lightest-loaded experts spill first under eviction.
    """

    lead = 1   # segments a segment's blobs are fetched ahead of its compute

    def __init__(self, engine: AsyncTransferEngine,
                 leaves_by_id: Dict[int, Any], n_experts: int,
                 expert_counts: Any = None):
        self.engine = engine
        self.leaves_by_id = dict(leaves_by_id)
        if not self.leaves_by_id:
            raise ValueError("ParamStream needs at least one streamed leaf")
        self.leaf_ids = tuple(sorted(int(k) for k in self.leaves_by_id))
        self.n_experts = int(n_experts)
        self.expert_counts = None if expert_counts is None \
            else np.asarray(expert_counts)
        self.plan: Optional[SegmentPlan] = None
        self.state_bytes = 0   # boundary-state size, recorded by the forward
        self.blob_bytes = {li: tree_bytes(arr[0, 0])
                           for li, arr in self.leaves_by_id.items()}
        self.step_param_bytes = sum(
            tree_bytes(arr[0]) for arr in self.leaves_by_id.values())

    # -- plan production ------------------------------------------------------
    def bind(self, plan: SegmentPlan) -> None:
        self.plan = plan

    def access_plan(self, phase: str) -> "ms.ResourceAccessPlan":
        """This stream's slice of the resource access IR for one phase."""
        assert self.plan is not None, "bind(plan) first"
        return ms.expert_access_plan(self.plan, self.leaf_ids, self.n_experts,
                                     self.expert_counts, phase=phase,
                                     blob_bytes=self.blob_bytes)

    def _expert_order(self, step: int) -> list:
        order = list(range(self.n_experts))
        if self.expert_counts is not None:
            row = self.expert_counts[step]
            order.sort(key=lambda e: (-int(row[e]), e))
        return order

    def segment_keys(self, seg: SegmentSpec, phase: str = "reverse") -> list:
        """One segment's blob keys in the phase's consumption order (steps
        reversed for the reverse phase; experts busiest-first within a
        step — the order of :func:`expert_access_plan`)."""
        steps = range(seg.begin, seg.end)
        if phase == "reverse":
            steps = reversed(list(steps))
        out = []
        for k in steps:
            for e in self._expert_order(k):
                for li in self.leaf_ids:
                    out.append(ms.expert_key(li, k, e))
        return out

    def population_order(self) -> tuple:
        """Canonical Level-2 write order of :meth:`populate` (each unique
        key once, soonest forward use first), the order
        ``fast_peak_bytes_resources`` replays."""
        return self.access_plan("forward").keys()

    # -- Level-2 verbs --------------------------------------------------------
    def populate(self) -> None:
        """Write every blob to Level 2 on the caller's thread, in the
        canonical order, so the sweeps stream them back instead of holding
        the whole stack.  The backend keeps its own host copy; for a run on
        the card that copy is page-locked (``page_locked_copy``), so the
        lane uploads it without staging it again."""
        backend = self.engine.backend
        device = getattr(self.engine, "device", None)
        pin = device is not None and device.type == "cuda"
        for key in self.population_order():
            _, li, step, e = key
            blob = self.leaves_by_id[li][step, e]
            if pin:
                blob = _frozen_views(page_locked_copy(blob))
            backend.put(key, blob)

    def prefetch_segment(self, seg: SegmentSpec,
                         phase: str = "reverse") -> None:
        self.engine.prefetch_params_async(self.segment_keys(seg, phase))

    def gather(self, leaf_id: int, seg: SegmentSpec):
        """One leaf's ``(seg_len, n_experts, ...)`` slice assembled from
        the streamed blobs (consuming the staged prefetches), on the
        engine's device."""
        wait = self.engine.wait_param
        rows = []
        for step in range(seg.begin, seg.end):
            rows.append(torch.stack([
                _as_tensor(wait(ms.expert_key(leaf_id, step, e)))
                for e in range(self.n_experts)]))
        return torch.stack(rows)

    def delete_segment(self, seg: SegmentSpec) -> None:
        """Retire a reversed segment's blobs (their last use is done)."""
        for key in self.segment_keys(seg, phase="reverse"):
            self.engine.delete(key)

    def purge(self) -> None:
        """Best-effort removal of every streamed blob (run teardown)."""
        if self.plan is None:
            return
        for key in self.population_order():
            try:
                self.engine.delete(key)
            except Exception:
                pass


def _as_tensor(a: Any):
    """A blob from the parameter lane as a tensor (an engine without a
    device hands back the backend's host arrays)."""
    return a if isinstance(a, torch.Tensor) else _host_tensor(a)



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
    resume: Optional[RecoveredRun] = None   # set when this run is a resume
    param_stream: Optional[ParamStream] = None  # streamed-resource lane

    def close(self) -> None:
        """Release this run's Level-2 state (idempotent).

        Boundary keys created by this run are purged from the backend —
        except when the backend is journaled: there the boundaries ARE the
        crash recovery state, and purging them on an error path would
        destroy exactly what ``resume_from=`` needs; a journaled run's keys
        are retired by the reverse sweep's ordered deletes (or superseded
        by the next ``begin_run``).  A parameter stream's blobs are purged.
        The engine and the backend are closed only when this run owns the
        engine.  ``engine.close()`` re-raises pending transfer errors."""
        if self.closed:
            return
        self.closed = True
        journaled = _journal_backend(self.engine) is not None
        try:
            if not journaled:
                for seg in self.plan.segments:
                    try:
                        self.engine.delete(seg.begin)
                    except Exception:
                        pass
            if self.param_stream is not None:
                self.param_stream.purge()
        finally:
            if self.own_engine:
                try:
                    self.engine.close()
                finally:
                    bclose = getattr(self.engine.backend, "close", None)
                    if bclose is not None:
                        try:
                            bclose()
                        except Exception:
                            pass


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
                           resume_from: Optional[RecoveredRun] = None,
                           run_meta: Optional[Dict[str, Any]] = None,
                           param_stream: Optional[ParamStream] = None,
                           ) -> "tuple[Any, MultistageRun]":
        """Phase 1: advance the chain to ``x_n`` while the engine
        asynchronously streams every ``interval``-th state to Level 2.
        Returns ``(x_n, run)``; hand ``run`` to :meth:`multistage_reverse`
        (or call ``run.close()`` to abandon it).  ``runner=None`` walks the
        segments with an :class:`InterpretedSegmentRunner` over this
        executor's operators (the reversing executor builds its own).

        With a journaled backend (``make_backend(..., journal=...)``) the
        forward pass is crash-consistent: a ``RunCursor`` rides the writer
        queue after each segment (FIFO => a durable cursor implies durable
        boundaries), and ``x_n`` is journaled under ``FINAL_STATE_KEY``.
        ``resume_from=`` (a :class:`~repro_torch.core.journal.RecoveredRun`
        from ``backend.recover()``) restarts a crashed run: a forward-phase
        crash replays from the largest durable boundary — at most one
        interval of re-executed steps, counted in
        ``ExecutionStats.replayed_advances`` — and a reverse-phase crash
        skips the forward entirely (``x_n`` comes back from the journal;
        :meth:`multistage_reverse` then restarts mid-sweep from the
        cursor's adjoint).  Host state read back from the journal is placed
        where ``state0`` lives before anything reads it.
        ``run_meta`` rides the journal's BEGIN record (the front-end's
        input fingerprint).  ``param_stream`` (a :class:`ParamStream`)
        writes its blobs to Level 2 first and fetches each segment's
        ``lead`` segments ahead of its compute; the run's runner reads
        them (``ParamStreamSegmentRunner``)."""
        own_engine = engine is None
        if engine is None:
            # prefetched boundaries come back where the chain runs
            engine = AsyncTransferEngine(
                RAMStorage(), device=pytree.tree_leaves(state0)[0].device)
        stats = ExecutionStats(n=n)
        slots = _L1Slots(stats)
        plan = ms.segment_plan(n, interval, s_l1)
        jb = _journal_backend(engine)
        run = MultistageRun(n=n, interval=interval, s_l1=s_l1, engine=engine,
                            stats=stats, slots=slots, plan=plan,
                            runner=runner, own_engine=own_engine,
                            param_stream=param_stream)
        fwd_runner = runner if runner is not None else \
            InterpretedSegmentRunner(self.forward_op, self.backward_op)
        # a capacity-bounded backend evicts by the plan's reverse access
        # order: the victim is the boundary needed farthest ahead (Belady).
        # With a parameter stream the order is the merged resource IR:
        # expert blobs rank by their forward use, boundary states (read
        # back only in the reverse) after all of them.
        set_plan = getattr(engine.backend, "set_plan", None)
        if param_stream is not None:
            try:
                param_stream.bind(plan)
                param_stream.state_bytes = tree_bytes(state0)
                if set_plan is not None:
                    set_plan(ms.merge_access_plans(
                        param_stream.access_plan("forward"),
                        plan.resource_access_plan(param_stream.state_bytes)
                            .shift(len(plan.segments))))
                # boundary prefetches must not reorder the fast tier either
                engine.prefetch_via_peek = True
                t_pop = time.perf_counter()
                param_stream.populate()
                stats.param_populate_s = time.perf_counter() - t_pop
            except BaseException:
                try:
                    run.close()
                except Exception:
                    pass
                raise
        elif set_plan is not None:
            set_plan(plan)
        cursor0 = None
        if resume_from is not None:
            if jb is None:
                raise ValueError(
                    "resume_from= requires a journaled Level-2 backend "
                    "(make_backend(..., journal=directory))")
            cursor0 = resume_from.cursor
            if cursor0 is not None and cursor0.phase == "done":
                # previous run completed cleanly: nothing to resume
                cursor0, resume_from = None, None
            if cursor0 is not None and not cursor0.matches(plan):
                raise StorageFault(
                    f"journal cursor is for {cursor0.plan_id}, cannot "
                    f"resume it under {plan.plan_id}")
        t0 = time.perf_counter()
        try:
            if cursor0 is not None and cursor0.phase == "reverse":
                # Forward completed before the crash: everything the sweep
                # needs is durable.  Validate, re-hydrate x_n, and let
                # multistage_reverse restart mid-sweep from the cursor.
                needed = [seg.begin for seg in
                          plan.segments[:cursor0.segment_index + 1]]
                missing = [b for b in needed if b not in engine.backend]
                if missing or FINAL_STATE_KEY not in engine.backend:
                    raise StorageFault(
                        f"cannot resume reverse sweep: journal is missing "
                        f"boundaries {missing or [FINAL_STATE_KEY]}")
                # exact raw record, not a lossy-codec round-trip: x_n
                # seeds the (recomputed) loss/readout and must match the
                # crashed run's in-memory state bit for bit
                current = placed(_exact_get(engine.backend, FINAL_STATE_KEY),
                                 state0)
                run.resume = resume_from
                stats.l2_stores = engine.num_stores
                stats.wall_s += time.perf_counter() - t0
                return current, run
            durable = set()
            start_idx = 0
            current = state0
            if resume_from is not None:
                run.resume = resume_from
                durable = {k for k in resume_from.keys
                           if isinstance(k, (int, np.integer))}
                # restart boundary: end of the *contiguous* durable prefix
                # (everything below it must be fetchable in the reverse)
                prefix_end = -1
                for seg in plan.segments:
                    if seg.begin in durable:
                        prefix_end = seg.sid
                    else:
                        break
                if prefix_end >= 0:
                    start_idx = prefix_end
                    b_star = plan.segments[start_idx].begin
                    # the crashed run advanced from the *exact* running
                    # state at b_star (lossy encodings only affect what
                    # the reverse sweep reads back), so a bit-identical
                    # replay must start from the raw journal record
                    current = placed(_exact_get(engine.backend, b_star),
                                     state0)
                    if cursor0 is not None:
                        # steps the pre-crash run provably completed and we
                        # now re-execute: last durable boundary up to the
                        # cursor's attested position — at most one interval
                        stats.replayed_advances = max(
                            0, plan.cursor_position(cursor0) - b_star)
            elif jb is not None:
                # run_meta rides the BEGIN record (e.g. the front-end's
                # input fingerprint, checked before a later resume)
                jb.begin_run({"plan_id": plan.plan_id, "n": n,
                              "interval": interval, "s_l1": s_l1,
                              **(run_meta or {})})
            # Fused runners produce the segment-entry boundary *from the
            # kernel* (already in page-locked host memory), so the store is
            # enqueued after the advance with the kernel's boundary instead
            # of snapshotting `current` before it.  The writer-queue FIFO
            # still orders the store before the segment's cursor, so journal
            # durability semantics are unchanged.
            aws = getattr(fwd_runner, "advance_with_store", None)
            # every carry of the chain has the carry's structure and shapes
            state_bytes = tree_bytes(current)
            if param_stream is not None:
                # warm the lane: the first `lead` segments' blobs start
                # moving before any compute does
                for pseg in plan.segments[start_idx:start_idx
                                          + param_stream.lead]:
                    param_stream.prefetch_segment(pseg, phase="forward")
            for seg in plan.segments[start_idx:]:
                if param_stream is not None:
                    # rolling lead: segment k+lead's blobs behind segment
                    # k's compute
                    nxt = seg.sid + param_stream.lead
                    if nxt < len(plan.segments):
                        param_stream.prefetch_segment(plan.segments[nxt],
                                                      phase="forward")
                if seg.begin in durable:
                    current = fwd_runner.advance(current, seg, stats)
                elif aws is not None:
                    current, boundary = aws(current, seg, stats)
                    engine.store_async(seg.begin, boundary)
                else:
                    engine.store_async(seg.begin, current)
                    current = fwd_runner.advance(current, seg, stats)
                slots.note_extra(state_bytes)
                if jb is not None:
                    engine.cursor_async(plan.cursor("forward", seg.sid + 1))
            if jb is not None:
                engine.store_async(FINAL_STATE_KEY, current)
        except BaseException:
            try:  # don't leak the writer thread / Level-2 states; don't
                run.close()  # let cleanup errors mask the original one
            except Exception:
                pass
            raise
        stats.l2_stores = engine.num_stores
        stats.wall_s += time.perf_counter() - t0
        return current, run

    def multistage_reverse(self, run: "MultistageRun", adjoint0: Any, *,
                           resume_from: Optional[RecoveredRun] = None,
                           artifact_fn: Optional[Callable[
                               [SegmentSpec], Any]] = None,
                           restore_artifact_fn: Optional[Callable[
                               [int, Any], None]] = None):
        """Phase 2: join outstanding stores, then reverse the chain segment
        by segment with Level-2 boundaries prefetched one segment ahead
        (double-buffering, the paper's schedule; a plan-aware backend may
        ask for more) and per-segment work delegated to the run's segment
        runner.  Returns ``(adjoint, stats)`` and closes the engine if this
        run owns it.

        With a journaled backend the sweep is crash-consistent: after each
        segment a ``RunCursor`` carrying the adjoint (snapshotted when it
        is enqueued) plus the runner's per-segment artifact from
        ``artifact_fn`` (e.g. per-step input cotangents) is enqueued
        *before* the boundary's delete — writer-queue FIFO keeps the
        journal's cursor/delete order honest.  ``resume_from=`` (or a
        resume recorded on the run by :meth:`multistage_forward`) restarts
        mid-sweep: already-reversed segments are never re-run (their
        contribution lives in the cursor's adjoint, placed where
        ``adjoint0`` lives; their artifacts are replayed through
        ``restore_artifact_fn``), so the resume cost is bounded by one
        segment regardless of chain length."""
        engine, stats, slots = run.engine, run.stats, run.slots
        runner = run.runner if run.runner is not None else \
            InterpretedSegmentRunner(self.forward_op, self.backward_op)
        segs = run.plan.segments
        jb = _journal_backend(engine)
        rec = resume_from if resume_from is not None else run.resume
        t0 = time.perf_counter()
        ps = run.param_stream
        try:
            adjoint = adjoint0
            engine.wait_stores()
            if ps is not None:
                # the forward's stores have all landed: boundary states and
                # expert blobs interleave by reverse segment rank under one
                # Belady order
                set_plan = getattr(engine.backend, "set_plan", None)
                if set_plan is not None:
                    set_plan(ms.merge_access_plans(
                        run.plan.resource_access_plan(ps.state_bytes),
                        ps.access_plan("reverse")))
            j_start = len(segs) - 1
            cursor = rec.cursor if rec is not None else None
            if cursor is not None and cursor.phase == "reverse":
                # restart mid-sweep: the cursor's adjoint already folds in
                # every segment above segment_index
                j_start = cursor.segment_index
                payload = cursor.payload or {}
                if payload.get("adjoint") is not None:
                    adjoint = placed(payload["adjoint"], adjoint0)
                if restore_artifact_fn is not None:
                    for b, art in rec.artifacts.items():
                        restore_artifact_fn(b, art)
            elif jb is not None:
                # durable mark: the sweep has begun with this seed adjoint
                # (a crash before the first segment completes resumes here)
                engine.cursor_async(run.plan.cursor(
                    "reverse", j_start, payload={"adjoint": adjoint}))
            # prefetch lead: 1 (double-buffer) unless the backend derives a
            # plan-aware distance (the stores above have all landed)
            depth = 1
            hint = getattr(engine.backend, "plan_prefetch_distance", None)
            if hint is not None:
                depth = max(1, int(hint(run.plan)))
            stats.prefetch_depth = depth
            for idx in range(j_start, max(j_start - depth, -1), -1):
                engine.prefetch_async(segs[idx].begin)
            if ps is not None:
                for idx in range(j_start, max(j_start - ps.lead, -1), -1):
                    ps.prefetch_segment(segs[idx], phase="reverse")
            for j in range(j_start, -1, -1):
                seg = segs[j]
                if j - depth >= 0:
                    engine.prefetch_async(segs[j - depth].begin)
                if ps is not None and j - ps.lead >= 0:
                    ps.prefetch_segment(segs[j - ps.lead], phase="reverse")
                x_b = engine.wait_prefetch(seg.begin)
                if j == j_start:   # a boundary has the carry's structure
                    state_bytes = tree_bytes(x_b)
                slots.note_extra(state_bytes)
                adjoint = runner.reverse(x_b, adjoint, seg, slots, stats)
                if ps is not None:
                    ps.delete_segment(seg)   # last use of these blobs
                if jb is not None:
                    artifact = artifact_fn(seg) if artifact_fn is not None \
                        else None
                    engine.cursor_async(run.plan.cursor(
                        "reverse", j - 1,
                        payload={"adjoint": adjoint,
                                 "artifact": artifact,
                                 "artifact_key": seg.begin}))
                    engine.delete_async(seg.begin)
                else:
                    engine.delete(seg.begin)
            if jb is not None:
                # done-cursor strictly BEFORE the final-state delete: a
                # crash between them recovers as phase=="done" (clean
                # fresh run); the reverse order would leave a journal
                # whose reverse cursor needs a FINAL_STATE_KEY that is
                # already gone — permanently unresumable
                engine.cursor_async(run.plan.cursor("done", -1))
                engine.delete_async(FINAL_STATE_KEY)
                engine.wait_stores()
                jb.end_run()
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
            stats.param_prefetches = engine.num_param_prefetches
            stats.param_fetch_stalls = engine.param_fetch_stalls
            stats.param_bytes_moved = engine.param_bytes_moved
            stats.param_stall_s = engine.param_stall_s
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
