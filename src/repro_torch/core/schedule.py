# Copy of repro/core/schedule.py (framework-free); keep the two in step.
"""Asynchronous multistage checkpointing schedule (the paper's §2).

Two storage levels:

* **Level 1** — fast, small (MCDRAM / HBM / this process's RAM): holds the
  running state plus up to ``s`` snapshots used by Revolve inside an interval.
* **Level 2** — large, slow (DRAM / SSD / host RAM): receives every ``I``-th
  state via an *asynchronous* store during the forward pass, and serves
  asynchronous prefetches during the backward pass.

The schedule below is the action stream the executor interprets.  Stores and
prefetches are explicitly asynchronous: ``STORE_L2`` / ``PREFETCH_L2`` enqueue
a transfer, ``WAIT_STORE`` / ``WAIT_PREFETCH`` join it.  Prefetches are
double-buffered: while interval ``j`` is being reversed, interval ``j-1``'s
checkpoint is already in flight.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from repro_torch.core import revolve as rv
from repro_torch.core.revolve import Action


def chunk_length(seg_len: int, s_l1: int) -> Optional[int]:
    """Chunk size for single-level checkpointed recomputation inside one
    segment: ``ceil(seg_len / s_l1)``, so at most ``s_l1`` chunk boundaries
    are ever saved (a shorter remainder chunk absorbs the leftover steps — no
    divisibility requirement).  ``None`` means no chunking: either the
    segment fits in Level 1 (store-all), or ``s_l1 < 2`` — a single-level
    checkpoint cannot beat store-all with one slot (the one chunk's interior
    rematerialises in full during its backward anyway), so we skip the
    pointless recompute.

    This is the planner's compiled/trace-native projection of the Revolve
    sub-plan: where :func:`segment_plan` attaches a step-granular Revolve
    action stream (exact optimal advance counts, driven by the interpreted
    engine), the XLA engines map the same segment onto ``jax.checkpoint``
    regions of this chunk length.  Peak Level-1 states for a chunked
    reversal are ``num_chunks + chunk`` (boundaries plus one chunk's
    interior during its backward) — the single-level analogue of
    Revolve-inside-the-interval, not its strict ``s`` bound."""
    if seg_len <= s_l1 or s_l1 < 2:
        return None
    return math.ceil(seg_len / s_l1)


# ---------------------------------------------------------------------------
# Inner (per-step) axis — the second dimension of a 2D plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InnerPlan:
    """Inner axis of a 2D plan: how one chain step's own computation is
    chunked during the reverse sweep.

    The outer axis (segments + Revolve) bounds how many *steps'* states are
    live; when a *single step's* activations exceed the budget — deep layer
    stacks per step, or a huge logits/loss head — the step itself must be
    chunked.  ``layer_chunks`` sub-ranges of the per-step layer stack are
    each wrapped in a remat region (only the ``layer_chunks`` sub-range
    entry states are saved; interiors are recomputed once during the step's
    backward, StreamBP-style exact chunking), and the logits/loss head is
    evaluated in ``head_chunks`` sequence chunks so the full logits tensor
    never materialises.

    ``boundaries`` are the chunk *start* layer indices chosen by the
    Gruslys-style DP (:func:`gruslys_split`): strictly increasing, first
    element 0, length ``layer_chunks``.
    """

    n_layers: int
    layer_chunks: int
    head_chunks: int = 1
    boundaries: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.n_layers < 1:
            raise ValueError(f"need n_layers >= 1, got {self.n_layers}")
        if not 1 <= self.layer_chunks <= self.n_layers:
            raise ValueError(
                f"need 1 <= layer_chunks <= n_layers ({self.n_layers}), "
                f"got {self.layer_chunks}")
        if self.head_chunks < 1:
            raise ValueError(f"need head_chunks >= 1, got {self.head_chunks}")
        if not self.boundaries:
            # uniform split by default
            per = self.n_layers / self.layer_chunks
            object.__setattr__(
                self, "boundaries",
                tuple(int(round(i * per)) for i in range(self.layer_chunks)))
        if len(self.boundaries) != self.layer_chunks \
                or self.boundaries[0] != 0 \
                or list(self.boundaries) != sorted(set(self.boundaries)) \
                or self.boundaries[-1] >= self.n_layers:
            raise ValueError(
                f"boundaries must be {self.layer_chunks} strictly increasing "
                f"layer indices starting at 0 and < {self.n_layers}; got "
                f"{self.boundaries}")

    def chunk_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """``(lo, hi)`` half-open layer sub-ranges, in application order."""
        ends = (*self.boundaries[1:], self.n_layers)
        return tuple(zip(self.boundaries, ends))

    @property
    def id_suffix(self) -> str:
        return f":L={self.layer_chunks}:H={self.head_chunks}"


def _minmax_partition(vals: Tuple[float, ...], k: int):
    """Partition ``vals`` into ``k`` contiguous chunks minimising the largest
    chunk sum.  Returns ``(best_max, boundaries)`` with ``boundaries`` the
    chunk start indices.  O(k * n^2) DP — n is a layer count, tiny."""
    n = len(vals)
    prefix = [0.0]
    for v in vals:
        prefix.append(prefix[-1] + float(v))

    def rng(i, j):  # sum of vals[i:j]
        return prefix[j] - prefix[i]

    INF = float("inf")
    # f[j][i]: minimal max-chunk-sum splitting vals[:i] into j chunks
    f = [[INF] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    f[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for m in range(j - 1, i):
                cand = max(f[j - 1][m], rng(m, i))
                if cand < f[j][i]:
                    f[j][i] = cand
                    cut[j][i] = m
    bounds = []
    i = n
    for j in range(k, 0, -1):
        m = cut[j][i]
        bounds.append(m)
        i = m
    return f[k][n], tuple(reversed(bounds))


def gruslys_split(layer_bytes, budget_bytes: float,
                  state_bytes: float) -> Optional[InnerPlan]:
    """Gruslys-style slot allocation for the inner axis: the smallest number
    of rematted layer sub-ranges whose reverse-time peak fits the budget.

    The peak while one step is backwarded with ``k`` chunks is

        ``k * state_bytes``  (saved sub-range entry states)
        ``+ max chunk activation bytes``  (the chunk being rematerialised),

    so for each candidate ``k`` the DP places boundaries to minimise the
    largest chunk (:func:`_minmax_partition` — the minmax analogue of
    Gruslys et al.'s optimal slot placement, arXiv:1606.03401), and the
    smallest feasible ``k`` wins: recompute cost is one extra forward of the
    step regardless of ``k`` (every chunk interior replays exactly once), so
    fewer chunks means fewer saved states and larger fusion regions at the
    same recompute.  Returns ``None`` when even ``k = n_layers`` does not
    fit — :func:`min_step_budget_bytes` names the smallest budget that would.
    """
    vals = tuple(float(b) for b in layer_bytes)
    n = len(vals)
    if n < 1:
        raise ValueError("need at least one layer cost")
    for k in range(1, n + 1):
        worst, bounds = _minmax_partition(vals, k)
        if k * float(state_bytes) + worst <= float(budget_bytes):
            return InnerPlan(n_layers=n, layer_chunks=k, boundaries=bounds)
    return None


def min_step_budget_bytes(layer_bytes, state_bytes: float) -> float:
    """Smallest per-step budget any inner split can satisfy (used by the
    launcher's infeasibility error)."""
    vals = tuple(float(b) for b in layer_bytes)
    best = float("inf")
    for k in range(1, len(vals) + 1):
        worst, _ = _minmax_partition(vals, k)
        best = min(best, k * float(state_bytes) + worst)
    return best


class MOp(enum.Enum):
    ADVANCE = "advance"          # forward steps [index, end)
    STORE_L2 = "store_l2"        # async: current state (== x_index) -> Level 2
    WAIT_STORES = "wait_stores"  # join all outstanding Level-2 stores
    PREFETCH_L2 = "prefetch_l2"  # async: x_index Level 2 -> Level 1 staging
    WAIT_PREFETCH = "wait_pref"  # join the prefetch of x_index; load into state
    FREE_L2 = "free_l2"          # drop x_index from Level 2
    REVERSE_SEGMENT = "reverse"  # reverse steps [index, end) with x_index in hand


@dataclass(frozen=True)
class MAction:
    op: MOp
    index: int = -1
    end: int = -1

    def __repr__(self) -> str:
        if self.op in (MOp.ADVANCE, MOp.REVERSE_SEGMENT):
            return f"{self.op.name}({self.index}->{self.end})"
        return f"{self.op.name}({self.index})"


# ---------------------------------------------------------------------------
# SegmentPlan IR — the *plan* stage of the plan -> compile -> execute engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentSpec:
    """One interval of the chain, with everything needed to run it.

    The forward phase stores ``x_begin`` to Level 2 and advances
    ``[begin, end)``; the reverse phase prefetches ``x_begin`` back and
    reverses the segment.  ``revolve`` is the intra-segment Revolve sub-plan
    (``None`` when the whole segment fits in Level 1, i.e. store-all).
    """

    sid: int                 # segment ordinal, forward order
    begin: int               # first step of the segment (== L2 boundary key)
    end: int                 # exclusive
    revolve: Optional[Tuple[Action, ...]] = None

    @property
    def length(self) -> int:
        return self.end - self.begin

    def __repr__(self) -> str:
        mode = "revolve" if self.revolve is not None else "store-all"
        return f"Segment#{self.sid}[{self.begin}:{self.end}|{mode}]"


@dataclass(frozen=True)
class TierPlan:
    """Plan-derived Level-2 tier annotations for a capacity-bounded
    (tiered) backend: which segment boundaries are expected fast-tier
    resident when their reverse turn comes, and how far ahead of need the
    reverse sweep should promote spilled boundaries.

    Built by :meth:`SegmentPlan.tier_plan`.  ``resident[j]`` refers to
    segment ``j`` in *forward* order; the reverse sweep consumes boundaries
    in descending ``begin`` order, so under the plan-aware (Belady) eviction
    rule the fast tier holds the ``fast_slots`` *largest* begins at the end
    of the forward sweep — exactly the boundaries needed first.
    """

    fast_slots: int               # boundary states the fast tier can hold
    resident: Tuple[bool, ...]    # per segment (forward order): fast at need?
    spilled: int                  # boundaries that must come from the slow tier
    prefetch_distance: int        # segments of lead for promotions (>= 1)

    @property
    def num_segments(self) -> int:
        return len(self.resident)


# ---------------------------------------------------------------------------
# ResourceAccessPlan IR — generic offloadable-resource access traces
# ---------------------------------------------------------------------------
#
# Historically the tiered backend consumed ``SegmentPlan.reverse_access_order``
# directly, hard-coding Level 2 to boundary states.  The IR below generalises
# that contract to *any* resource class with a predictable access schedule: an
# access plan is an ordered trace of ``(resource_key, use_index)`` entries,
# and any producer can emit one — ``SegmentPlan.resource_access_plan`` for
# boundary states, :func:`expert_access_plan` for MoE expert parameter blobs
# (per-expert next-use order derived from routing statistics).  Plans merged
# with :func:`merge_access_plans` put heterogeneous resource classes under one
# capacity budget with a single farthest-next-use (Belady) order.


@dataclass(frozen=True)
class ResourceAccess:
    """One entry of a :class:`ResourceAccessPlan`: resource ``key`` is
    consumed at trace position ``use_index`` (smaller = needed sooner).
    ``size_bytes`` (0 = unknown) feeds heterogeneous-size residency
    accounting (:meth:`ResourceAccessPlan.tier_residency`)."""

    key: Any
    use_index: int
    size_bytes: int = 0


@dataclass(frozen=True)
class ResourceAccessPlan:
    """Typed access trace over Level-2 resources — the generic IR behind
    plan-aware eviction.

    ``use_index`` is the rank of the consuming event (for executor-produced
    plans: the rank of the consuming segment in its phase), so plans from
    different producers interleave correctly under
    :func:`merge_access_plans` (a stable merge: ties keep producer order).
    A key may appear multiple times; eviction ranks use its *first* (i.e.
    soonest) use.
    """

    accesses: Tuple[ResourceAccess, ...]

    @property
    def num_accesses(self) -> int:
        return len(self.accesses)

    def _first_uses(self) -> dict:
        first: dict = {}
        for pos, a in enumerate(self.accesses):
            if a.key not in first:
                first[a.key] = (a.use_index, pos)
        return first

    def keys(self) -> Tuple[Any, ...]:
        """Unique keys, soonest first use first."""
        first = self._first_uses()
        return tuple(sorted(first, key=first.get))

    def distances(self) -> dict:
        """Belady distance map ``{key: rank}`` — 0 is needed first; the
        eviction victim maximises this rank.  This is what a capacity-bounded
        backend's ``set_plan`` consumes."""
        return {k: d for d, k in enumerate(self.keys())}

    def sizes(self) -> dict:
        """``{key: size_bytes}`` from each key's first access entry."""
        first = self._first_uses()
        out: dict = {}
        for a in self.accesses:
            if a.key not in out and a.key in first:
                out[a.key] = int(a.size_bytes)
        return out

    def shift(self, offset: int) -> "ResourceAccessPlan":
        """The same trace displaced ``offset`` use ranks later — how a
        producer whose consumption starts after another's is composed
        (e.g. boundary states, only read in the reverse phase, shifted
        past all forward expert uses)."""
        return ResourceAccessPlan(accesses=tuple(
            ResourceAccess(a.key, a.use_index + int(offset), a.size_bytes)
            for a in self.accesses))

    def tier_residency(self, capacity_bytes: int):
        """Heterogeneous-size Belady residency: admit keys in ascending
        next-use order while their bytes fit the budget.  Returns
        ``(resident_keys, spilled_count, resident_bytes)`` — the generic
        analogue of :meth:`SegmentPlan.tier_plan`'s uniform-state slot
        accounting (zero-sized keys are admitted for free)."""
        sizes = self.sizes()
        resident, used, spilled = [], 0, 0
        for k in self.keys():
            nb = max(0, int(sizes.get(k, 0)))
            if used + nb <= int(capacity_bytes):
                resident.append(k)
                used += nb
            else:
                spilled += 1
        return tuple(resident), spilled, used


def merge_access_plans(*plans: ResourceAccessPlan) -> ResourceAccessPlan:
    """Stable merge by ``use_index``: one joint farthest-next-use order over
    every resource class (ties resolve in producer-argument order)."""
    acc = [a for p in plans for a in p.accesses]
    acc.sort(key=lambda a: a.use_index)  # stable: ties keep producer order
    return ResourceAccessPlan(accesses=tuple(acc))


def expert_key(leaf_id: int, step: int, expert: int) -> tuple:
    """Level-2 key of one expert's parameter blob for one chain step:
    ``("xp", leaf_id, step, expert)``.  Deliberately non-``int``: the
    executor's resume path classifies durable *boundary* keys by int-ness,
    and ``MultistageRun.close`` purges expert keys separately."""
    return ("xp", int(leaf_id), int(step), int(expert))


def expert_access_plan(plan: "SegmentPlan", leaf_ids, n_experts: int,
                       expert_counts=None, *, phase: str = "reverse",
                       blob_bytes=0) -> ResourceAccessPlan:
    """Producer 2 of the generic resource IR: MoE expert parameter blobs in
    the order the given phase consumes them.

    ``phase="forward"`` ranks accesses by segment ``sid`` (each segment's
    compute reads its steps' experts); ``phase="reverse"`` by reverse rank
    (and steps within a segment in descending order, matching the vjp's
    consumption).  Within one step, experts are ordered by *descending
    routed-token count* from ``expert_counts`` (an ``(n, n_experts)`` array
    of routing statistics, e.g. ``models.moe.routing_stats``): the busiest
    experts rank soonest, so under joint Belady eviction the lightest-loaded
    experts spill first.  ``expert_counts=None`` falls back to uniform
    (expert-index) order.  ``blob_bytes`` is an int or a ``{leaf_id: bytes}``
    map."""
    if phase not in ("forward", "reverse"):
        raise ValueError(f"phase must be 'forward' or 'reverse', got {phase}")

    def blob(li):
        return int(blob_bytes[li]) if isinstance(blob_bytes, dict) \
            else int(blob_bytes)

    segs = plan.segments if phase == "forward" \
        else tuple(reversed(plan.segments))
    accesses = []
    for rank, seg in enumerate(segs):
        steps = range(seg.begin, seg.end)
        if phase == "reverse":
            steps = reversed(range(seg.begin, seg.end))
        for k in steps:
            order = list(range(n_experts))
            if expert_counts is not None:
                row = expert_counts[k]
                order.sort(key=lambda e: (-int(row[e]), e))
            for e in order:
                for li in leaf_ids:
                    accesses.append(ResourceAccess(
                        key=expert_key(li, k, e), use_index=rank,
                        size_bytes=blob(li)))
    return ResourceAccessPlan(accesses=tuple(accesses))


@dataclass(frozen=True)
class RunCursor:
    """Serializable position of a multistage run inside its plan —
    checkpointed through the Level-2 journal at segment granularity so a
    crashed run resumes from its last durable segment instead of t=0.

    Semantics by ``phase``:

    * ``"forward"`` — ``segment_index`` segments have completed their
      advance; the chain position in steps is
      :meth:`SegmentPlan.cursor_position`.  A durable forward cursor also
      guarantees (writer-queue FIFO) that every boundary store enqueued
      before it is durable, so resume replays at most one interval.
    * ``"reverse"`` — ``segment_index`` is the *next* segment to reverse
      (``num_segments - 1`` at sweep start, ``-1`` when done);
      ``payload["adjoint"]`` is the host-snapshot adjoint ready for that
      segment, ``payload["artifact"]``/``payload["artifact_key"]`` carry
      the just-reversed segment's runner artifact (e.g. per-step input
      cotangents) so the front-end can stitch full-chain cotangents after
      a resume.
    * ``"done"`` — the reverse sweep completed; nothing to resume.

    ``revolve_pos`` reserves sub-segment granularity (position inside the
    segment's Revolve sub-plan); the executor currently checkpoints at
    segment boundaries only, so it is always 0.
    """

    plan_id: str
    n: int
    interval: int
    s_l1: int
    phase: str            # "forward" | "reverse" | "done"
    segment_index: int
    revolve_pos: int = 0
    payload: Any = None

    def matches(self, plan: "SegmentPlan") -> bool:
        return self.plan_id == plan.plan_id and self.n == plan.n \
            and self.interval == plan.interval and self.s_l1 == plan.s_l1


@dataclass(frozen=True)
class SegmentPlan:
    """Per-interval plan for an ``n``-step chain: the IR the executor drives
    and the compile cache is keyed from.

    Segments are listed in forward order; the reverse sweep walks them
    backwards with double-buffered Level-2 prefetch (while segment ``j`` is
    reversed, segment ``j-1``'s boundary is already in flight).  The legacy
    flat ``MAction`` stream (``multistage_schedule``) is *derived* from this
    plan, so the two can never disagree.

    ``inner`` is the optional second axis (:class:`InnerPlan`): when set,
    the plan is 2D — the per-step computation itself is chunked during the
    reverse.  A 1D plan's ``plan_id`` is byte-identical to what it was
    before the second axis existed, so journaled cursors from 1D runs stay
    valid; a 2D plan appends ``:L=<layer_chunks>:H=<head_chunks>``.
    """

    n: int
    interval: int
    s_l1: int
    segments: Tuple[SegmentSpec, ...]
    inner: Optional[InnerPlan] = None

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def plan_id(self) -> str:
        """Stable identity of this plan — what a journaled
        :class:`RunCursor` is validated against on resume."""
        base = f"plan:n={self.n}:I={self.interval}:s={self.s_l1}"
        return base + self.inner.id_suffix if self.inner is not None else base

    def cursor(self, phase: str, segment_index: int,
               payload: Any = None) -> RunCursor:
        return RunCursor(plan_id=self.plan_id, n=self.n,
                         interval=self.interval, s_l1=self.s_l1,
                         phase=phase, segment_index=segment_index,
                         payload=payload)

    def cursor_position(self, cursor: RunCursor) -> int:
        """Chain position (in steps) a forward-phase cursor attests to."""
        if cursor.segment_index >= self.num_segments:
            return self.n
        return self.segments[cursor.segment_index].begin

    def boundaries(self) -> List[int]:
        return [seg.begin for seg in self.segments]

    def store_events(self) -> List[int]:
        """Level-2 store events (one per segment boundary, forward order) —
        identical across engines by construction: the executor engines issue
        one ``store_async`` per entry, the scan engine tags one offloaded
        boundary carry per entry."""
        return self.boundaries()

    def reverse_access_order(self) -> Tuple[int, ...]:
        """Boundary keys in the exact order the reverse sweep consumes them
        (descending ``begin``).  This is what makes Level-2 eviction
        plan-aware: the next-needed boundary is always the *largest*
        remaining begin, so the Belady victim is the smallest."""
        return tuple(seg.begin for seg in reversed(self.segments))

    def resource_access_plan(self, state_bytes: int = 0) -> ResourceAccessPlan:
        """Producer 1 of the generic resource IR
        (:class:`ResourceAccessPlan`): this plan's boundary states in exact
        reverse consumption order — :meth:`reverse_access_order` expressed
        as a typed access trace, one use per reverse segment rank, so it
        merges (``merge_access_plans``) with other resource classes' traces
        into one joint eviction order."""
        return ResourceAccessPlan(accesses=tuple(
            ResourceAccess(key=b, use_index=r, size_bytes=int(state_bytes))
            for r, b in enumerate(self.reverse_access_order())))

    def tier_plan(self, capacity_bytes: int, state_bytes: int,
                  t_t_slow: Optional[float] = None,
                  t_seg_reverse: Optional[float] = None) -> TierPlan:
        """Tier residency / prefetch-distance annotations for a
        capacity-bounded Level-2 backend holding one ``state_bytes``
        boundary per segment.

        With ``k = capacity_bytes // state_bytes`` fast-tier slots and
        plan-aware eviction, the end-of-forward resident set is the ``k``
        largest begins; each is freed right after its reverse turn, so a
        segment is served from the fast tier iff it is among the last ``k``
        (``resident[j] == (num_segments - j <= k)``).  The other
        ``spilled`` boundaries are promoted back ahead of need; the
        prefetch distance is ``ceil(t_t_slow / t_seg_reverse)`` segments of
        reverse work when the two times are given (the §3 overlap rule
        applied to the slow tier), else 2 — one segment of extra lead over
        the plain double-buffer — and 1 when nothing spills.
        """
        m = self.num_segments
        k = m if state_bytes <= 0 else \
            min(m, int(capacity_bytes) // int(state_bytes))
        resident = tuple(m - j <= k for j in range(m))
        spilled = m - k
        if spilled <= 0:
            distance = 1
        elif t_t_slow is not None and t_seg_reverse is not None \
                and t_seg_reverse > 0:
            distance = max(1, min(m, math.ceil(t_t_slow / t_seg_reverse)))
        else:
            distance = min(m, 2)
        return TierPlan(fast_slots=k, resident=resident,
                        spilled=max(0, spilled),
                        prefetch_distance=distance)

    def segment_lengths(self) -> Tuple[int, ...]:
        """Distinct segment lengths, descending — one compiled
        advance/reverse pair exists per entry (the tail adds at most one)."""
        return tuple(sorted({seg.length for seg in self.segments},
                            reverse=True))

    def inner_chunk(self, seg: SegmentSpec) -> Optional[int]:
        """The XLA engines' projection of ``seg``'s Revolve sub-plan: the
        ``jax.checkpoint`` chunk length for recomputation inside the segment
        (``None`` when the segment fits in Level 1 and is replayed
        store-all)."""
        if seg.revolve is None:
            return None
        return chunk_length(seg.length, self.s_l1)

    def reverse_advances(self) -> int:
        total = 0
        for seg in self.segments:
            if seg.revolve is None:   # store-all replay: len-1 advances
                total += seg.length - 1
            else:
                total += rv.count_advances(list(seg.revolve))
        return total

    def total_advances(self) -> int:
        return self.n + self.reverse_advances()


def segment_plan(n: int, interval: int, s_l1: int,
                 inner: Optional[InnerPlan] = None) -> SegmentPlan:
    """Build the SegmentPlan IR for an n-step chain (validates arguments;
    uneven tail segments are first-class — the last segment is simply
    shorter).  Pass ``inner`` to make the plan 2D."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    if interval < 1:
        raise ValueError(f"need interval >= 1, got {interval}")
    if s_l1 < 1:
        raise ValueError(f"need s_l1 >= 1, got {s_l1}")
    segments = []
    for sid, b in enumerate(range(0, n, interval)):
        e = min(b + interval, n)
        sub = rv.revolve_subplan(e - b, s_l1, offset=b) if e - b > s_l1 \
            else None
        segments.append(SegmentSpec(sid=sid, begin=b, end=e, revolve=sub))
    return SegmentPlan(n=n, interval=interval, s_l1=s_l1,
                       segments=tuple(segments), inner=inner)


@dataclass
class MultistageSchedule:
    """Schedule for reversing an ``n``-step chain with interval ``I`` and
    ``s_l1`` Level-1 snapshot slots per interval.

    ``segment_schedules`` maps a segment start index to the Revolve action
    stream used inside that segment (only populated when the segment does not
    fit entirely in Level-1 memory, i.e. ``segment_len > s_l1``).
    """

    n: int
    interval: int
    s_l1: int
    actions: List[MAction] = field(default_factory=list)
    segment_schedules: dict = field(default_factory=dict)

    # -- accounting used by tests and the perf model --------------------------
    @property
    def num_segments(self) -> int:
        return math.ceil(self.n / self.interval)

    def forward_advances(self) -> int:
        return sum(
            a.end - a.index for a in self.actions if a.op is MOp.ADVANCE
        )

    def reverse_advances(self) -> int:
        total = 0
        for a in self.actions:
            if a.op is not MOp.REVERSE_SEGMENT:
                continue
            seg = self.segment_schedules.get(a.index)
            if seg is None:  # store-all-in-L1 reversal: len-1 advances
                total += (a.end - a.index) - 1
            else:
                total += rv.count_advances(seg)
        return total

    def total_advances(self) -> int:
        return self.forward_advances() + self.reverse_advances()

    def recompute_factor(self) -> float:
        """Total forward advances / (n - 1); 1.0 == no recomputation, matching
        ``revolve.recompute_factor``'s convention.  Includes the initial
        forward sweep (n advances), so the minimum for multistage is n/(n-1).
        """
        if self.n <= 1:
            return 1.0
        return self.total_advances() / (self.n - 1)

    def l2_stores(self) -> int:
        return sum(1 for a in self.actions if a.op is MOp.STORE_L2)


def multistage_schedule(n: int, interval: int, s_l1: int) -> MultistageSchedule:
    """Build the asynchronous multistage schedule for an n-step chain.

    Forward: advance in segments of ``interval``; asynchronously store each
    segment-boundary state to Level 2.  Reverse: prefetch boundary states
    (double-buffered) and reverse each segment with Revolve(segment_len, s_l1)
    — which degenerates to store-all when ``segment_len <= s_l1``.

    If ``n <= interval`` there is only one segment and the schedule degenerates
    to classic Revolve, as §3 of the paper notes.

    The flat action stream is derived from the :class:`SegmentPlan` IR
    (``segment_plan``) — the plan is the single source of truth; this view of
    it exists for accounting, tests and debugging.
    """
    plan = segment_plan(n, interval, s_l1)
    sched = MultistageSchedule(n=n, interval=interval, s_l1=s_l1)
    acts = sched.actions
    segs = plan.segments

    # ---- forward phase ------------------------------------------------------
    for seg in segs:
        acts.append(MAction(MOp.STORE_L2, seg.begin))
        acts.append(MAction(MOp.ADVANCE, seg.begin, seg.end))
    acts.append(MAction(MOp.WAIT_STORES))

    # ---- reverse phase ------------------------------------------------------
    # Prefetch the last boundary immediately; then double-buffer.
    acts.append(MAction(MOp.PREFETCH_L2, segs[-1].begin))
    for j in range(len(segs) - 1, -1, -1):
        seg = segs[j]
        if j > 0:
            acts.append(MAction(MOp.PREFETCH_L2, segs[j - 1].begin))
        acts.append(MAction(MOp.WAIT_PREFETCH, seg.begin))
        acts.append(MAction(MOp.REVERSE_SEGMENT, seg.begin, seg.end))
        acts.append(MAction(MOp.FREE_L2, seg.begin))
        if seg.revolve is not None:
            # Segment does not fit in L1: Revolve within the interval.
            sched.segment_schedules[seg.begin] = list(seg.revolve)

    return sched


def multistage_recompute_factor(n: int, interval: int, s_l1: int) -> float:
    """Physical recompute factor of the multistage strategy: ALL forward
    advances (the initial sweep + the per-segment reversal replays) over
    (n - 1).  Constant in n for fixed ``interval``:
    R -> 1 + t(I, s)/I ~ 2 - 1/I for I <= s+1.
    """
    if n <= 1:
        return 1.0
    total = n  # initial forward sweep
    for b in range(0, n, interval):
        seg = min(interval, n - b)
        total += rv.optimal_advances(seg, s_l1) if seg > 1 else 0
    return total / (n - 1)


def multistage_recompute_factor_paper(n: int, interval: int,
                                      s_l1: int) -> float:
    """The paper's §3 convention: R(I, s) — the Revolve factor *within* one
    interval (1.0 == segment fits in Level 1; the initial forward sweep is
    counted as the baseline, not as recomputation).  This is what the
    paper's Figure 3 plots: flat in n, == classic Revolve's R(I, s).
    """
    if n <= 1:
        return 1.0
    adv = 0
    base = 0
    for b in range(0, n, interval):
        seg = min(interval, n - b)
        adv += rv.optimal_advances(seg, s_l1) if seg > 1 else 0
        base += max(seg - 1, 1)
    return adv / base if base else 1.0
