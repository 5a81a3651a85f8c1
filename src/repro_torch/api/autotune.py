# Port of repro/api/autotune.py: TuneResult, snap_interval, default_slots,
# AutoTuner.measure (one Level-2 stream) and AutoTuner.manual.
"""Schedule auto-tuning from the paper's §3 performance model.

The multistage strategy has two knobs: the Level-2 store interval ``I`` and
the Level-1 slot count ``s``.  §3 gives the optimum directly:
``I = ceil(T_T / T_A)`` — the smallest interval at which the asynchronous
Level-2 transfers keep up with compute.

``AutoTuner.measure`` times one segment probe of the runner the run will use
(``T_A`` = its time over its length) and one Level-2 ``put`` of the boundary
state (``T_T``), on the device the run uses — on the card these are the
card's own numbers; nothing is taken from a data sheet or another chip.
The interval is snapped with :func:`snap_interval` and cached per
``(model, seq-len, state size, Level-2 kind, device)``.  Scan-engine,
roofline, 2D, tiered and sharded tuning come later (ROADMAP queue 1,
items 9, 11, 13 and 15).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.perfmodel import H100, HardwareSpec, optimal_interval
from repro_torch.core.storage import tree_bytes


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

    Cache key: ``(name, n, state_bytes, level2-kind, device)``.  ``hw`` is
    the hardware the tuner plans for (default: the H100); its numbers are
    not used by :meth:`measure`, which times the device in hand.
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

    def measure(self, name: str, *,
                forward_segment: Callable[[Any], Any],
                segment_len: int, state0: Any, n: int, backend: Any,
                store_state0: Any = None) -> TuneResult:
        """Time the forward compute and one Level-2 store; derive ``I``
        per §3.

        ``forward_segment(state) -> state`` advances ``segment_len`` steps;
        ``T_A`` is its time over its length, i.e. the *amortised* per-step
        time the segment runner achieves (the probe synchronises the device
        before the clock stops).  ``T_T`` is one ``backend.put`` of the
        boundary state.  ``store_state0`` substitutes the value fed to the
        store probe: the fused runner passes a host copy, because its kernel
        has already written the boundary to host memory by the time the
        store is issued.
        """
        state_bytes = tree_bytes(state0)
        key = (name, n, state_bytes, type(backend).__name__,
               _device_kind(state0))
        cached = self.lookup(key)
        if cached is not None:
            return dataclasses.replace(cached, probe_calls=0)

        def one_probe():
            _synchronize(forward_segment(state0))

        t_a = self._time(one_probe) / max(1, segment_len)
        tune_key = ("__autotune__", name)
        store_val = state0 if store_state0 is None else store_state0

        def one_store():
            backend.put(tune_key, store_val)

        t_t = self._time(one_store)
        backend.delete(tune_key)
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
