# Copy of repro/core/perfmodel.py (framework-free); keep the two in step.
"""Performance model (paper §3), parameterised over hardware.

Times for one training (forward+backward) iteration of an ``n``-step chain:

    T_inf     = n * T_A + n * T_B                          (no memory limit)
    T_revolve = n * R(n, s) * T_A + n * T_B                (single-stage)
    T_async   = n * R(I, s) * T_A + n * T_B                (multistage, async)

with ``I = ceil(T_T / T_A)`` the smallest interval at which the Level-2
transfers (``T_T`` per state) keep up with compute.  ``R(I, s) <= R(n, s)``
whenever ``I <= n``, so the asynchronous strategy is never slower — and its
overhead is constant in ``n`` (paper's headline claim).

If a *smaller* interval is forced (I < ceil(T_T/T_A)), stores cannot keep up
and the forward pass stalls; ``t_async`` models that with a
``max(I*T_A, T_T)`` per-segment forward time so the trade-off is visible.

``HardwareSpec`` carries the roofline constants for the target chip; the
dry-run couples this model to measured HLO terms via ``times_from_roofline``.

The two-tier section below extends §3 to a capacity-bounded Level 2
(``TieredStorage``): once boundaries overflow the fast tier, the effective
per-state transfer time is the write-behind bottleneck ``max(T_T_fast,
T_T_slow)``, and ``choose_tiered_interval`` applies ``I = ceil(T_T/T_A)``
to that effective time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import revolve as rv


@dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants. Defaults: TPU v5e-class chip."""

    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # HBM bytes/s per chip
    ici_bw: float = 50e9              # bytes/s per ICI link
    d2h_bw: float = 25e9              # device->host offload bytes/s per chip
    dcn_bw: float = 1.5625e9          # cross-pod bytes/s per chip
                                      # (6.25 GB/s host NIC / 4 chips/host)
    hbm_bytes: float = 16e9           # HBM capacity per chip
    num_ici_links: int = 4


TPU_V5E = HardwareSpec()
# The paper's platforms, for reproducing its tables on the executor path.
KNL = HardwareSpec(name="knl", peak_flops=3.0e12, hbm_bw=450e9,
                   d2h_bw=90e9, hbm_bytes=16e9)          # MCDRAM -> DRAM
CPU_SSD = HardwareSpec(name="cpu-ssd", peak_flops=1.0e12, hbm_bw=100e9,
                       d2h_bw=2e9, hbm_bytes=64e9)       # DRAM -> SSD
# NVIDIA H100 SXM, the port's target (NVIDIA data sheet, dense rates at the
# 700 W limit).  ``peak_flops`` keeps the field's bf16 meaning; the port's
# kernels are fp32 on the CUDA cores, bounded by H100_FP32_FLOPS.  The host
# link has no data-sheet number here: the autotuner measures T_T on the
# card, so ``d2h_bw``/``dcn_bw`` stay NaN and any model that needs them
# fails loudly instead of using a guess.
H100 = HardwareSpec(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                    ici_bw=450e9, d2h_bw=float("nan"), dcn_bw=float("nan"),
                    hbm_bytes=80e9, num_ici_links=1)     # NVLink: 450 GB/s/way
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores (data sheet)


# ---------------------------------------------------------------------------


def optimal_interval(t_transfer: float, t_advance: float) -> int:
    """I = ceil(T_T / T_A): smallest interval that never stalls compute."""
    if t_advance <= 0:
        raise ValueError("t_advance must be positive")
    return max(1, math.ceil(t_transfer / t_advance))


def t_inf(n: int, t_a: float, t_b: float) -> float:
    return n * (t_a + t_b)


def t_revolve(n: int, s: int, t_a: float, t_b: float) -> float:
    return n * rv.recompute_factor(n, s) * t_a + n * t_b


def t_async(n: int, interval: int, s: int, t_a: float, t_b: float,
            t_t: float) -> float:
    """Multistage runtime.  At the paper's operating point
    (interval >= ceil(T_T/T_A)) this reduces to
    ``n * R(I, s) * T_A + n * T_B``; for smaller intervals the per-segment
    forward time is transfer-bound and the stall appears explicitly.

    With n <= interval the strategy degenerates to classic Revolve (§3).
    """
    if n <= interval:
        return t_revolve(n, s, t_a, t_b)
    segments = math.ceil(n / interval)
    fwd_per_seg = max(interval * t_a, t_t)     # stall if transfers lag
    # reverse: per segment, Revolve(I, s) recomputation + backward steps; the
    # prefetch of the next segment overlaps, costing time only if it exceeds
    # the segment's reverse work.
    seg_recompute = rv.optimal_advances(min(interval, n), s) if interval > 1 else 0
    rev_per_seg = max(seg_recompute * t_a + interval * t_b, t_t)
    return segments * (fwd_per_seg + rev_per_seg)


def speedup_vs_revolve(n: int, interval: int, s: int, t_a: float,
                       t_b: float, t_t: float) -> float:
    return t_revolve(n, s, t_a, t_b) / t_async(n, interval, s, t_a, t_b, t_t)


# ---------------------------------------------------------------------------
# Two-tier (capacity-bounded) Level-2 model
# ---------------------------------------------------------------------------
#
# A TieredStorage Level 2 has a fast tier of ``capacity_bytes`` and a slow
# tier behind it.  While every boundary fits the fast tier, the per-state
# transfer time is the fast tier's T_T.  Once ceil(n/I) boundaries overflow
# the budget, steady state is write-behind: every new fast-tier store forces
# an eviction through the slow tier, so the *effective* per-boundary
# transfer time is rate-limited by the slower medium — and §3's
# I = ceil(T_T/T_A) must be applied to that effective time.


def fast_tier_slots(capacity_bytes: float, state_bytes: float) -> int:
    """Boundary states the fast tier can hold (0 when one state alone
    overflows the budget and every boundary bypasses to the slow tier)."""
    if state_bytes <= 0:
        raise ValueError("state_bytes must be positive")
    return int(capacity_bytes // state_bytes)


def effective_transfer_time(n: int, interval: int, state_bytes: float,
                            capacity_bytes: float, t_t_fast: float,
                            t_t_slow: float) -> float:
    """Capacity-aware per-boundary transfer time: the fast tier's ``T_T``
    while all ``ceil(n/I)`` boundaries fit, else the write-behind pipeline's
    bottleneck ``max(T_T_fast, T_T_slow)`` (fast store and slow eviction
    overlap, so the slower stage sets the rate)."""
    segments = math.ceil(n / interval)
    if segments <= fast_tier_slots(capacity_bytes, state_bytes):
        return t_t_fast
    return max(t_t_fast, t_t_slow)


def choose_tiered_interval(n: int, state_bytes: float, capacity_bytes: float,
                           t_a: float, t_t_fast: float,
                           t_t_slow: float) -> int:
    """§3's ``I = ceil(T_T/T_A)`` applied to the *effective* two-tier
    transfer time.

    Candidates, smallest viable wins:

    * ``I_fast = ceil(T_T_fast/T_A)`` — valid only if all ``ceil(n/I_fast)``
      boundaries fit the fast tier (no spill, fast-tier rate);
    * otherwise the smaller of ``I_fit`` (the smallest interval at which the
      boundaries all fit — paying recompute to stay on the fast medium) and
      ``I_slow = ceil(max(T_T_fast,T_T_slow)/T_A)`` (accepting the spill and
      sizing the interval so the slow tier keeps up — the paper's DRAM->SSD
      operating point).
    """
    i_fast = optimal_interval(t_t_fast, t_a)
    k = fast_tier_slots(capacity_bytes, state_bytes)
    if k >= 1 and math.ceil(n / i_fast) <= k:
        return i_fast
    i_slow = optimal_interval(max(t_t_fast, t_t_slow), t_a)
    if k < 1:                      # nothing ever fits: slow tier sets I
        return max(i_fast, i_slow)
    i_fit = math.ceil(n / k)
    return max(i_fast, min(i_fit, i_slow))


def t_async_tiered(n: int, interval: int, s: int, t_a: float, t_b: float,
                   t_t_fast: float, t_t_slow: float, state_bytes: float,
                   capacity_bytes: float) -> float:
    """Two-tier multistage runtime: :func:`t_async` evaluated at the
    capacity-aware effective transfer time.  At ``I >= ceil(T_T_eff/T_A)``
    this is ``n * R(I, s) * T_A + n * T_B`` — the overhead stays constant
    in ``n`` even when most boundaries live on the slow tier, which is the
    tiered backend's headline claim (wall time flat while the fast tier
    obeys any budget)."""
    t_t_eff = effective_transfer_time(n, interval, state_bytes,
                                      capacity_bytes, t_t_fast, t_t_slow)
    return t_async(n, interval, s, t_a, t_b, t_t_eff)


def fast_peak_bytes_model(n: int, interval: int, state_bytes: int,
                          capacity_bytes: int) -> int:
    """Model of the fast tier's high-water mark: every boundary when they
    fit, else exactly the budget's worth of whole states (plan-aware
    eviction keeps the tier full of the soonest-needed boundaries)."""
    segments = math.ceil(n / interval)
    k = fast_tier_slots(capacity_bytes, state_bytes)
    return min(segments, k) * int(state_bytes)


def admitted_fast_peak_model(n: int, interval: int, state_bytes: int,
                             capacity_bytes: int, *,
                             extra_states: int = 0) -> int:
    """Admission-control upper bound on a run's fast-tier footprint.

    :func:`fast_peak_bytes_model` counts segment boundaries only; a
    *journaled* run additionally stores the final carry under
    ``FINAL_STATE_KEY``, so a scheduler admitting a preemptible train job
    must budget ``extra_states=1`` or the measured peak can exceed the
    prediction by one state and falsify the admission contract.  Decode
    sessions use ``extra_states=0`` with ``n == interval`` (their cache is
    one resident "state").
    """
    if extra_states < 0:
        raise ValueError(f"extra_states must be >= 0, got {extra_states}")
    segments = math.ceil(n / interval) + extra_states
    k = fast_tier_slots(capacity_bytes, state_bytes)
    return min(segments, k) * int(state_bytes)


# ---------------------------------------------------------------------------
# Streamed-resource (expert parameter) extension of the two-tier model
# ---------------------------------------------------------------------------
#
# With ``offload_params`` the Level-2 link moves two resource classes: one
# boundary state per segment (as above) plus every segment's expert-parameter
# working set (``interval * step_param_bytes`` fetched behind the previous
# segment's compute, forward AND reverse).  §3's never-stall rule gains the
# param term: the link must clear ``T_T_state + I * t_p`` inside ``I * T_A``.
# The fast tier is shared — ``fast_peak_bytes_resources`` replays the
# backend's exact put sequence under the merged plan's Belady order, so the
# modeled peak equals the measured ``fast_peak_bytes`` bit for bit.


def expert_traffic_model(n: int, interval: int, step_param_bytes: float,
                         state_bytes: float, capacity_bytes: float) -> dict:
    """Level-2 traffic and residency of an expert-streaming run.

    One forward+reverse pass populates every blob once (``n *
    step_param_bytes``) and reads each twice (once per phase), on top of
    the boundary-state traffic; residency-wise the streamed working set and
    the ``ceil(n/I)`` boundaries compete for one ``capacity_bytes`` budget,
    so ``spilled_bytes`` is what the write-behind pipeline must cycle
    through the slow tier."""
    segments = math.ceil(n / interval)
    seg_param_bytes = interval * float(step_param_bytes)
    total_param_bytes = n * float(step_param_bytes)
    resident_demand = total_param_bytes + segments * float(state_bytes)
    spilled = max(0.0, resident_demand - float(capacity_bytes))
    return {
        "segments": segments,
        "seg_param_bytes": seg_param_bytes,
        "total_param_bytes": total_param_bytes,
        # populate once + forward reads + reverse reads
        "moved_param_bytes": 3 * total_param_bytes,
        "resident_demand_bytes": resident_demand,
        "spilled_bytes": spilled,
    }


def choose_interval_with_params(t_a: float, t_t_state: float,
                                t_p: float) -> int:
    """§3's ``I = ceil(T_T/T_A)`` extended with per-step parameter traffic.

    ``t_p`` is the transfer time of one step's expert working set
    (``step_param_bytes / bandwidth``).  A segment of ``I`` steps gives the
    link ``I * T_A`` to move one boundary state *and* the next segment's
    params: ``I * T_A >= T_T_state + I * t_p``, i.e.
    ``I = ceil(T_T_state / (T_A - t_p))``.  When params alone saturate the
    link (``t_p >= T_A``) no interval avoids stalls — fall back to the
    state-only rule (the stall then shows up in ``param_fetch_stalls``
    rather than being hidden by an unboundedly large interval)."""
    if t_a <= 0:
        raise ValueError("t_a must be positive")
    if t_p >= t_a:
        return optimal_interval(t_t_state, t_a)
    return max(1, math.ceil(t_t_state / (t_a - t_p)))


def fast_peak_bytes_resources(puts, distances: dict,
                              capacity_bytes: int) -> int:
    """*Exact* replay of ``TieredStorage``'s fast tier over a heterogeneous
    put sequence — the streamed-resource generalisation of
    :func:`fast_peak_bytes_model`.

    ``puts`` is the backend's put order as ``(key, nbytes)`` pairs (for an
    ``offload_params`` run: the ``ParamStream.population_order`` blobs, then
    one boundary state per segment — population is synchronous and boundary
    stores drain through the single FIFO writer, so the order is
    deterministic); ``distances`` is the merged forward access plan's
    ``ResourceAccessPlan.distances()``.  The replay mirrors the backend
    exactly: oversize puts bypass, a re-store drops the old copy first,
    eviction pops the max-rank victim (unknown keys first, LRU; then
    farthest next use) until the budget holds, and the peak is recorded
    *after* eviction — so the returned value must equal the measured
    ``fast_peak_bytes`` exactly, which the expert_stream bench asserts at
    every sweep point."""
    capacity = int(capacity_bytes)
    fast: dict = {}
    seq: dict = {}
    next_seq = 0
    fill = 0
    peak = 0

    def rank(k):
        d = distances.get(k)
        if d is None:
            return (1, -seq.get(k, 0))
        return (0, d)

    for key, nb in puts:
        nb = int(nb)
        if nb > capacity:
            continue                      # bypasses the fast tier
        if key in fast:                   # re-store replaces the old copy
            fill -= fast.pop(key)
            seq.pop(key, None)
        fast[key] = nb
        fill += nb
        seq[key] = next_seq
        next_seq += 1
        while fill > capacity and fast:
            victim = max(fast, key=rank)
            fill -= fast.pop(victim)
            seq.pop(victim, None)
        peak = max(peak, fill)
    return peak


# ---------------------------------------------------------------------------
# Sharded (per-device Level-2 streams) model
# ---------------------------------------------------------------------------
#
# On a mesh, every device owns a shard of each boundary state and streams it
# to its *own* Level-2 stream, so the per-stream payload is the local shard
# — ``state_bytes / num_shards`` when the state is evenly sharded — and the
# streams run concurrently.  §3's rule then applies to the per-stream
# transfer time, which is never larger than the global one, hence
# ``I_sharded <= I_single`` whenever the fan-out actually parallelises.


def local_shard_bytes(state_bytes: float, num_shards: int) -> float:
    """Per-stream payload of one boundary state on an even mesh split."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return state_bytes / num_shards


def sharded_transfer_time(t_t_global: float, num_shards: int,
                          efficiency: float = 1.0) -> float:
    """Per-stream ``T_T`` predicted from the single-stream time: the
    payload divides by ``num_shards`` and the streams overlap, degraded
    by ``efficiency`` in (0, 1] for host-side contention (shared PCIe
    root, one filesystem behind N writer threads)."""
    if not 0.0 < efficiency <= 1.0:
        raise ValueError(f"efficiency must be in (0, 1], got {efficiency}")
    return local_shard_bytes(t_t_global, num_shards) / efficiency


def choose_sharded_interval(t_a: float, t_t_stream: float,
                            t_t_global: float | None = None) -> int:
    """§3's ``I = ceil(T_T/T_A)`` at the *per-stream* transfer time,
    clamped by the global time: ``min(T_T_stream, T_T_global)`` is
    monotone in both arguments, so the sharded interval can never exceed
    the single-device one even when a measured fan-out probe comes back
    noisy-slow (contended CI machine)."""
    t_t = t_t_stream if t_t_global is None else min(t_t_stream, t_t_global)
    return optimal_interval(t_t, t_a)


def t_async_sharded(n: int, interval: int, s: int, t_a: float, t_b: float,
                    t_t_global: float, num_shards: int,
                    efficiency: float = 1.0) -> float:
    """Multistage runtime with per-device Level-2 streams: :func:`t_async`
    at the per-stream transfer time.  With ``num_shards == 1`` this is
    exactly the single-device model."""
    t_t = sharded_transfer_time(t_t_global, num_shards, efficiency)
    return t_async(n, interval, s, t_a, t_b, t_t)


def mesh_axis_transfer_times(state_bytes: float, mesh_shape: dict,
                             d2h_bw: float) -> dict:
    """Roofline per-axis ``T_T``: the per-stream time if the state were
    sharded along each mesh axis alone (``mesh_shape`` is the
    ``{axis: size}`` dict of a ``jax.sharding.Mesh``).  The dry-run uses
    this to pick which axis to put in ``state_spec`` before measuring."""
    return {axis: local_shard_bytes(state_bytes, max(1, int(k))) / d2h_bw
            for axis, k in mesh_shape.items()}


# ---------------------------------------------------------------------------
# 2D (time x layer) plan model
# ---------------------------------------------------------------------------
#
# The outer axis bounds how many *steps'* states are live; when a single
# step's own activations exceed the per-step budget (deep per-step layer
# stacks, huge logits/loss heads — the regime ROADMAP's StreamBP x Gruslys
# item names), the step must be chunked too.  ``choose_2d_plan`` decides
# 1D-vs-2D from real per-layer costs (``analysis.jaxpr_cost``), allocates
# inner slots with the Gruslys-style DP (``schedule.gruslys_split``) and
# models both the recompute factor and the per-step peak as functions of
# both axes; the bench asserts the executor's counters match count-exactly.


def inner_boundary_bytes_model(inner, state_bytes: float) -> float:
    """Saved inner sub-range entry states while one step is backwarded:
    ``layer_chunks * state_bytes`` (0 for a 1D plan).  This is the
    measurable half of the per-step peak — the executor counts exactly the
    boundary saves it dispatches."""
    if inner is None:
        return 0.0
    return inner.layer_chunks * float(state_bytes)


def inner_peak_bytes_model(inner, layer_bytes, state_bytes: float) -> float:
    """Modeled reverse-time per-step peak of a 2D plan: the saved sub-range
    boundaries plus the largest chunk's activations (the chunk being
    rematerialised).  For a 1D plan (``inner is None``) the whole step's
    activations are live at once."""
    vals = tuple(float(b) for b in layer_bytes)
    if inner is None:
        return sum(vals)
    peak = inner_boundary_bytes_model(inner, state_bytes)
    worst = max(sum(vals[lo:hi]) for lo, hi in inner.chunk_ranges())
    return peak + worst


def inner_recomputed_layers_model(n: int, inner) -> int:
    """Count-exact model of the inner axis's recompute: every chunk interior
    replays exactly once when its step is backwarded, so a full reverse
    sweep re-runs ``n * n_layers`` layer applications (0 for 1D)."""
    if inner is None:
        return 0
    return int(n) * int(inner.n_layers)


def recompute_factor_2d(n: int, interval: int, s_l1: int, inner) -> float:
    """Combined recompute factor of a 2D plan, in the physical
    (``multistage_recompute_factor``) convention: the outer factor plus one
    extra forward of every step's layer stack for the inner remat —
    independent of ``layer_chunks`` (exact chunking, constant overhead,
    StreamBP-style)."""
    from repro_torch.core.schedule import multistage_recompute_factor
    base = multistage_recompute_factor(n, interval, s_l1)
    if inner is None:
        return base
    return base + n / max(1, n - 1)


@dataclass(frozen=True)
class Plan2D:
    """Outcome of the 1D-vs-2D decision for one chain under a per-step
    budget.  ``inner is None`` means time-only segmentation suffices."""

    interval: int
    inner: object                  # Optional[schedule.InnerPlan]
    step_bytes_1d: float           # one step's activations, unchunked
    step_peak_bytes: float         # modeled per-step reverse peak (chosen plan)
    inner_boundary_bytes: float    # measurable: saved inner boundaries
    recompute_factor: float        # both axes, physical convention
    feasible: bool
    min_budget_bytes: float        # smallest budget any inner split satisfies

    @property
    def is_2d(self) -> bool:
        return self.inner is not None


def choose_2d_plan(n: int, *, t_a: float, t_t: float, s_l1: int,
                   state_bytes: float, layer_bytes,
                   budget_bytes: float, head_bytes: float = 0.0,
                   interval: "int | None" = None) -> Plan2D:
    """Pick 1D vs 2D for an ``n``-step chain under ``budget_bytes`` of
    per-step memory.

    The outer interval stays §3's ``I = ceil(T_T/T_A)`` (outer boundaries
    live in Level 2; the budget constrains the *per-step* reverse peak, not
    the boundary count).  If one step's unchunked activations
    (``sum(layer_bytes) + head_bytes``) fit the budget, the answer is 1D.
    Otherwise the Gruslys-style DP (:func:`~repro.core.schedule.gruslys_split`)
    finds the fewest layer sub-ranges whose peak fits, and the logits/loss
    head is split into the fewest sequence chunks that fit.  ``feasible`` is
    False when even ``layer_chunks == n_layers`` overflows;
    ``min_budget_bytes`` then names the smallest budget that would work
    (what the launcher error reports).
    """
    from repro_torch.core import schedule as sched
    if interval is None:
        interval = optimal_interval(t_t, t_a)
    vals = tuple(float(b) for b in layer_bytes)
    step_1d = sum(vals) + float(head_bytes)
    min_budget = sched.min_step_budget_bytes(vals, state_bytes)
    if step_1d <= budget_bytes:
        return Plan2D(interval=interval, inner=None, step_bytes_1d=step_1d,
                      step_peak_bytes=step_1d, inner_boundary_bytes=0.0,
                      recompute_factor=recompute_factor_2d(
                          n, interval, s_l1, None),
                      feasible=True, min_budget_bytes=min_budget)
    inner = sched.gruslys_split(vals, budget_bytes, state_bytes)
    if inner is None:
        return Plan2D(interval=interval, inner=None, step_bytes_1d=step_1d,
                      step_peak_bytes=step_1d, inner_boundary_bytes=0.0,
                      recompute_factor=recompute_factor_2d(
                          n, interval, s_l1, None),
                      feasible=False, min_budget_bytes=min_budget)
    if head_bytes > 0 and budget_bytes > 0:
        head_chunks = max(1, math.ceil(float(head_bytes) / budget_bytes))
        if head_chunks > 1:
            inner = sched.InnerPlan(
                n_layers=inner.n_layers, layer_chunks=inner.layer_chunks,
                head_chunks=head_chunks, boundaries=inner.boundaries)
    return Plan2D(
        interval=interval, inner=inner, step_bytes_1d=step_1d,
        step_peak_bytes=inner_peak_bytes_model(inner, vals, state_bytes),
        inner_boundary_bytes=inner_boundary_bytes_model(inner, state_bytes),
        recompute_factor=recompute_factor_2d(n, interval, s_l1, inner),
        feasible=True, min_budget_bytes=min_budget)


# ---------------------------------------------------------------------------
# Coupling to the roofline terms of a compiled program
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepTimes:
    """Per-chain-step times derived from compiled-HLO roofline terms."""

    t_a: float   # forward time of one step (layer / sequence chunk)
    t_b: float   # backward time of one step
    t_t: float   # Level-2 transfer time of one boundary state
    interval: int

    @property
    def never_stalls(self) -> bool:
        return self.t_t <= self.interval * self.t_a


def times_from_roofline(step_flops: float, step_hbm_bytes: float,
                        state_bytes: float, hw: HardwareSpec,
                        bwd_fwd_ratio: float = 2.0) -> StepTimes:
    """Derive (T_A, T_B, T_T, I) for one chain step from its roofline terms.

    ``T_A`` is the max of the compute and memory roofline times (the step runs
    at whichever bound dominates); ``T_B`` defaults to 2x forward (one step of
    backprop does ~2x the forward FLOPs); ``T_T`` is the boundary-state
    offload time at the device->host bandwidth.
    """
    t_a = max(step_flops / hw.peak_flops, step_hbm_bytes / hw.hbm_bw)
    t_b = bwd_fwd_ratio * t_a
    t_t = state_bytes / hw.d2h_bw
    return StepTimes(t_a=t_a, t_b=t_b, t_t=t_t,
                     interval=optimal_interval(t_t, t_a))
