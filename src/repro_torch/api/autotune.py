# Port of repro/api/autotune.py: TuneResult, snap_interval, default_slots,
# AutoTuner.measure (one Level-2 stream; the per-step and per-segment
# probes; the tiered backend's slow-tier probe; the parameter-lane read
# probe), AutoTuner.measure_scan and AutoTuner.manual.
"""Schedule auto-tuning from the paper's §3 performance model.

The multistage strategy has two knobs: the Level-2 store interval ``I`` and
the Level-1 slot count ``s``.  §3 gives the optimum directly:
``I = ceil(T_T / T_A)`` — the smallest interval at which the asynchronous
Level-2 transfers keep up with compute.

``AutoTuner.measure`` times the forward compute the run will use (``T_A``:
one interpreted step, or one segment probe of the runner over its length)
and one Level-2 store of a boundary made through the engine's own store
path (``T_T``: the snapshot and the writer's put the run makes), on the
device the run uses — on the card these are the card's own numbers; nothing
is taken from a data sheet or another chip.  A capacity-bounded
(``TieredStorage``) backend gets a second store probe through its slow tier
(``T_T_slow``), and ``I`` comes from the capacity-aware effective transfer
time (``perfmodel.choose_tiered_interval``).  The interval is snapped with
:func:`snap_interval` and cached per ``(model and engine, seq-len, state
size, Level-2 kind and budget, device)``.  Scan-engine, roofline, 2D and
sharded tuning come later (ROADMAP queue 1, items 11, 13 and 15).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import offload as ofl
from repro_torch.core.perfmodel import (H100, KNL, HardwareSpec,
                                        choose_interval_with_params,
                                        choose_tiered_interval,
                                        effective_transfer_time,
                                        optimal_interval)
from repro_torch.core.storage import TieredStorage, tree_bytes


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """A chosen schedule plus the measurements behind it."""

    interval: int
    slots: int
    t_a: float            # forward time of one chain step (s)
    t_t: float            # Level-2 transfer time of one boundary state (s)
    state_bytes: int
    n: int
    source: str           # "measured" | "manual"
    # the T_A probe of this call: forward_segment calls made, each over
    # probe_len chain steps (0 for a manual or cached schedule)
    probe_calls: int = 0
    probe_len: int = 0
    # tiered backend: slow-tier transfer time of one boundary state (s) and
    # the fast-tier budget the interval was chosen for
    t_t_slow: float = 0.0
    capacity_bytes: Optional[int] = None
    # parameter streaming: Level-2 read time of one step's streamed blobs
    t_t_param: float = 0.0


def snap_interval(n: int, target: int) -> int:
    """Snap the §3 optimum onto the chain: the smallest divisor of ``n`` in
    ``[target, 2*target]`` (even segments), never *below* the optimum; with
    none in range the target itself is kept and the plan ends in a shorter
    tail segment."""
    target = max(1, min(target, n))
    hi = min(n, 2 * target)
    for i in range(target, hi + 1):
        if n % i == 0:
            return i
    return target


def default_slots(interval: int, l1_budget_states: int = 16) -> int:
    """Level-1 slots for Revolve inside one interval.  ``interval <= s``
    degenerates to store-all within the segment (R(I, s) == 1, the paper's
    preferred operating point); larger intervals get the full budget."""
    return max(1, min(interval, l1_budget_states))


def _synchronize(tree: Any) -> None:
    """Wait for the device work that produces ``tree`` (the counterpart of
    ``jax.block_until_ready``)."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def _device_kind(tree: Any) -> str:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return torch.cuda.get_device_name(leaf.device)
    return "cpu"


class AutoTuner:
    """Measures (T_A, T_T) once and caches the chosen schedule.

    Cache key: ``(name, n, state_bytes, level2-kind, device)``, the kind
    of a tiered backend with its budget; the front-end's ``name`` carries
    the engine and runner, whose probes differ.  ``hw`` is the hardware the tuner plans for (default: the
    H100); its numbers are not used by :meth:`measure`, which times the
    device in hand.
    """

    def __init__(self, l1_budget_states: int = 16, repeats: int = 3,
                 hw: HardwareSpec = H100):
        self.l1_budget_states = l1_budget_states
        self.repeats = repeats
        self.hw = hw
        self._cache: Dict[Tuple, TuneResult] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ cache
    def lookup(self, key: Tuple) -> Optional[TuneResult]:
        with self._lock:
            return self._cache.get(key)

    def store(self, key: Tuple, result: TuneResult) -> TuneResult:
        with self._lock:
            self._cache[key] = result
        return result

    # ---------------------------------------------------------------- measure
    def _time(self, fn: Callable[[], Any]) -> float:
        fn()  # warmup (kernel build / first touch)
        t0 = time.perf_counter()
        for _ in range(self.repeats):
            fn()
        return (time.perf_counter() - t0) / self.repeats

    def measure(self, name: str, *, state0: Any, n: int, engine: Any,
                forward_step: Optional[Callable[[Any, int], Any]] = None,
                forward_segment: Optional[Callable[[Any], Any]] = None,
                segment_len: int = 1,
                store_tree: Optional[Callable[[], Any]] = None,
                param_stream_bytes: int = 0) -> TuneResult:
        """Time the forward compute and one Level-2 store; derive ``I``
        per §3.

        Two compute probes, one per engine:

        * ``forward_step(state, k) -> state`` — the interpreted engine's
          per-step op; one call gives ``T_A`` (host dispatch included);
        * ``forward_segment(state) -> state`` over ``segment_len`` steps —
          a segment runner's advance; ``T_A`` is its time over its length,
          the *amortised* per-step time that runner achieves.

        The probe synchronises the device before the clock stops.  ``T_T``
        is one store through ``engine.store_now``: the same snapshot and
        writer-side put that ``store_async`` makes in the run.
        ``store_tree()`` (optional) gives what the run hands the store in
        place of ``state0``: for the fused runner, a chunk entry that the
        last probe's fused advance wrote (its in-kernel copy is inside
        ``T_A``; the store pays only the rest).  Over a journaled backend
        the put is the journal's (a STORE record, then the inner store's
        put), as in the run, and the cache keys the schedule on it.

        A :class:`TieredStorage` backend is probed once more through its
        slow tier with the same payload (``T_T_slow``).  When one state
        overflows the budget the fast probe itself went to the slow tier,
        so ``T_T`` is the cheaper of the two; ``I`` is
        ``perfmodel.choose_tiered_interval``'s, and a snap below it is
        kept only while the effective transfer time still hides behind a
        segment's compute.

        ``param_stream_bytes`` (parameter streaming) is the size of one
        chain step's streamed blobs: a third probe puts that many bytes
        into Level 2 and times their non-promoting read back
        (``t_t_param``, the traffic the parameter lane adds to every
        segment), and ``I`` widens to
        ``perfmodel.choose_interval_with_params`` so the boundary store
        still hides behind the compute the reads leave.
        """
        backend = engine.backend
        state_bytes = tree_bytes(state0)
        level2 = type(backend).__name__
        if isinstance(backend, TieredStorage):
            # the optimum depends on the budget: key it into the cache
            level2 = f"{level2}[{backend.capacity_bytes}]"
        if param_stream_bytes:
            # the reads added to every segment move the optimum
            level2 = f"pstream[{param_stream_bytes}]:{level2}"
        key = (name, n, state_bytes, level2, _device_kind(state0))
        cached = self.lookup(key)
        if cached is not None:
            return dataclasses.replace(cached, probe_calls=0)

        if forward_segment is not None:
            def one_probe():
                _synchronize(forward_segment(state0))
        elif forward_step is not None:
            segment_len = 1

            def one_probe():
                _synchronize(forward_step(state0, 0))
        else:
            raise TypeError("measure() needs forward_step or "
                            "forward_segment")

        t_a = self._time(one_probe) / max(1, segment_len)
        tune_key = ("__autotune__", name)
        tree = state0 if store_tree is None else store_tree()

        def one_store():
            # the previous probe's entry goes first, so its page-locked
            # buffer is reused, as each call after a run's first reuses
            # the buffers the previous call freed
            backend.delete(tune_key)
            engine.store_now(tune_key, tree)

        t_t = self._time(one_store)
        backend.delete(tune_key)
        t_t_slow = 0.0
        capacity = None
        if isinstance(backend, TieredStorage):
            capacity = backend.capacity_bytes

            def one_slow_store():
                backend.slow.delete(tune_key)
                engine.store_now(tune_key, tree, backend=backend.slow)

            t_t_slow = self._time(one_slow_store)
            backend.slow.delete(tune_key)
            if state_bytes > capacity:
                # the fast probe bypassed to the slow tier: the cheaper of
                # the two is the fast tier's own time
                t_t = min(t_t, t_t_slow)
            target = choose_tiered_interval(n, state_bytes, capacity, t_a,
                                            t_t, t_t_slow)
        else:
            target = optimal_interval(t_t, t_a)
        t_t_param = 0.0
        if param_stream_bytes:
            # one step's blob bytes, read back as the lane reads them
            pkey = ("__autotune_param__", name)
            blob = np.zeros(max(1, param_stream_bytes // 4), np.float32)
            blob.setflags(write=False)   # a store keeps it without a copy
            backend.put(pkey, blob)
            del blob
            read = getattr(backend, "peek", None) or backend.get

            t_t_param = self._time(lambda: read(pkey))
            backend.delete(pkey)
            # widen, never shrink: the tiered minimum stays a floor
            target = max(target, choose_interval_with_params(
                t_a, t_t, t_t_param))
        interval = snap_interval(n, target)
        if capacity is not None and interval < target:
            # the tiered target is a minimum viable interval: a snap onto a
            # smaller divisor stays only while the transfers still hide
            t_t_eff = effective_transfer_time(n, interval, state_bytes,
                                              capacity, t_t, t_t_slow)
            if t_t_eff > interval * t_a:
                interval = target
        slots = default_slots(interval, self.l1_budget_states)
        return self.store(key, TuneResult(
            interval=interval, slots=slots, t_a=t_a, t_t=t_t,
            state_bytes=state_bytes, n=n, source="measured",
            probe_calls=1 + self.repeats, probe_len=segment_len,
            t_t_slow=t_t_slow, capacity_bytes=capacity,
            t_t_param=t_t_param))

    # ------------------------------------------------------- scan engine
    def measure_scan(self, name: str, *, body: Callable[..., Any],
                     params: Any, carry0: Any, xs: Any, batch: Any,
                     n: int, segment_len: int = 32) -> TuneResult:
        """Schedule for the scan engine (``engine="scan"``).

        Two probes, on the caller's own inputs under ``no_grad`` (the
        reference builds zero stand-ins from shapes alone, since its inputs
        may be tracers; torch inputs never are, and stand-ins would hold a
        second copy of the weights on the card and route every MoE token
        the same way):

        * ``T_A`` — the per-step time of one segment of ``segment_len``
          steps of ``body(params, carry, x, batch)`` without a graph, the
          segments' forward;
        * ``T_T`` — on the card, one copy of the boundary into page-locked
          host memory, the copy the segment policy makes; elsewhere the §3
          roofline estimate ``state_bytes / d2h_bw`` from the ``KNL``
          entry, as the reference uses where it cannot offload.

        The cache key's Level-2 kind is ``"pinned_host"`` or
        ``"roofline-knl"``, and the front-end passes ``"<spec>:scan"`` as
        ``name``, so a scan-tuned interval is never reused for the executor
        engines.
        """
        state_bytes = tree_bytes(carry0)
        device = pytree.tree_leaves(carry0)[0].device
        offloads = ofl.host_offload_supported(device)
        level2 = ofl.HOST if offloads else f"roofline-{KNL.name}"
        key = (name, n, state_bytes, level2, _device_kind(carry0))
        cached = self.lookup(key)
        if cached is not None:
            return dataclasses.replace(cached, probe_calls=0)

        segment_len = max(1, min(segment_len, n))

        def probe():
            c = carry0
            with torch.no_grad():
                for k in range(segment_len):
                    c = body(params, c, pytree.tree_map(lambda t: t[k], xs),
                             batch)
            _synchronize(c)

        t_a = self._time(probe) / segment_len
        if offloads:
            leaves = [t.detach() for t in pytree.tree_leaves(carry0)]
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in leaves]

            def one_store():
                for h, t in zip(hosts, leaves):
                    h.copy_(t, non_blocking=True)
                torch.cuda.synchronize(device)

            t_t = self._time(one_store)
        else:
            t_t = state_bytes / KNL.d2h_bw
        interval = snap_interval(n, optimal_interval(t_t, t_a))
        slots = default_slots(interval, self.l1_budget_states)
        return self.store(key, TuneResult(
            interval=interval, slots=slots, t_a=t_a, t_t=t_t,
            state_bytes=state_bytes, n=n, source="measured",
            probe_calls=1 + self.repeats, probe_len=segment_len))

    def manual(self, name: str, *, n: int, interval: int,
               slots: Optional[int] = None,
               state_bytes: int = 0) -> TuneResult:
        """A pinned schedule with no measurement (``source="manual"``).

        >>> AutoTuner().manual("doc", n=32, interval=8).interval
        8
        """
        return TuneResult(
            interval=max(1, min(interval, n)),
            slots=slots if slots is not None
            else default_slots(interval, self.l1_budget_states),
            t_a=0.0, t_t=0.0, state_bytes=state_bytes, n=n, source="manual")


# The process-wide tuner used by the front-end when none is supplied.
GLOBAL_TUNER = AutoTuner()
