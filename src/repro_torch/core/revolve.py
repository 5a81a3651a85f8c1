# Copy of repro/core/revolve.py (framework-free); keep the two in step.
"""Classic Revolve (Griewank & Walther, Algorithm 799) — optimal single-stage
binomial checkpointing.

Conventions
-----------
A *chain* of ``n`` sequential steps ``F_1 .. F_n`` maps state ``x_0`` to
``x_n``.  Reversal needs the states ``x_{n-1}, ..., x_0`` in reverse order.
``s`` snapshot slots are available, *including* the slot that permanently
holds the initial state of the (sub-)chain being reversed.

``t(n, s)`` is the minimal number of forward ADVANCE operations needed to
reverse the chain (every advance is counted, including the first sweep).
Griewank--Walther closed form::

    beta(s, r) = C(s + r, s)
    r  = min r such that beta(s, r) >= n       (the "repetition number")
    t(n, s) = r * n - beta(s + 1, r - 1)

A *recompute factor* of 1 means no recomputation: reversing ``n`` steps
requires at least ``n - 1`` advances (to reach ``x_{n-1}``), so::

    R(n, s) = t(n, s) / (n - 1)      for n > 1, else 1.0

This is the quantity plotted in the paper's Figures 3 and 5 (R grows ~log(n)
for fixed ``s``).

The schedule generator emits an action stream executed by
``repro.core.executor.CheckpointExecutor``.
"""
from __future__ import annotations

import enum
import functools
import math
from dataclasses import dataclass
from typing import Iterator, List


# ---------------------------------------------------------------------------
# Closed-form optimal cost
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def beta(s: int, r: int) -> int:
    """beta(s, r) = C(s + r, s): max chain length reversible with ``s`` slots
    and repetition number ``r`` (each step advanced at most ``r`` times)."""
    if r < 0:
        return 1 if r == -1 else 0  # beta(s, -1) == 1 by the GW convention
    return math.comb(s + r, s)


@functools.lru_cache(maxsize=None)
def repetition_number(n: int, s: int) -> int:
    """Smallest r with beta(s, r) >= n."""
    if n <= 0:
        raise ValueError(f"need n >= 1, got {n}")
    if s <= 0:
        raise ValueError(f"need s >= 1, got {s}")
    r = 0
    while beta(s, r) < n:
        r += 1
    return r


def optimal_advances(n: int, s: int) -> int:
    """t(n, s): minimal total forward advances to reverse an n-step chain with
    s snapshot slots (closed form, exact)."""
    if n == 1:
        return 0
    r = repetition_number(n, s)
    return r * n - beta(s + 1, r - 1)


def recompute_factor(n: int, s: int) -> float:
    """R(n, s) with R == 1.0 meaning no recomputation (paper's convention)."""
    if n <= 1:
        return 1.0
    return optimal_advances(n, s) / (n - 1)


def optimal_advances_dp(n: int, s: int) -> int:
    """O(n^2 s) dynamic program for t(n, s) — used by tests to validate the
    closed form on small inputs."""

    @functools.lru_cache(maxsize=None)
    def t(n_: int, s_: int) -> int:
        if n_ == 1:
            return 0
        if s_ == 1:
            return n_ * (n_ - 1) // 2
        return min(m + t(n_ - m, s_ - 1) + t(m, s_) for m in range(1, n_))

    return t(n, s)


# ---------------------------------------------------------------------------
# Schedule generation
# ---------------------------------------------------------------------------


class Op(enum.Enum):
    """Actions understood by the executor.

    ADVANCE   — run forward steps ``begin..end`` (exclusive), carrying state.
    STORE     — snapshot the current state (index attached) into a slot.
    RESTORE   — load the snapshot of state ``index`` into the current state.
    FREE      — release the slot holding state ``index``.
    BACKWARD  — run the combined forward+backward for step ``index + 1``
                (consumes state ``x_index``, produces adjoint contribution).
    """

    ADVANCE = "advance"
    STORE = "store"
    RESTORE = "restore"
    FREE = "free"
    BACKWARD = "backward"


@dataclass(frozen=True)
class Action:
    op: Op
    index: int  # state index (STORE/RESTORE/FREE/BACKWARD) or begin (ADVANCE)
    end: int = -1  # exclusive end state index for ADVANCE

    def __repr__(self) -> str:  # compact, for debugging / golden tests
        if self.op is Op.ADVANCE:
            return f"A({self.index}->{self.end})"
        return f"{self.op.name[0]}({self.index})"


def _optimal_split(n: int, s: int) -> int:
    """Position (offset from chain begin) of the first checkpoint for an
    optimal reversal of an n-step chain with s slots.

    Tries the well-known closed-form candidates first and verifies each via
    the closed-form cost; falls back to a scan (only ever needed for small n).
    """
    r = repetition_number(n, s)
    target = optimal_advances(n, s)
    cands = {
        beta(s - 1, r - 1),
        beta(s - 1, r - 1) + beta(s - 1, r - 2),
        n - beta(s, r - 1),
        beta(s, r - 1),
    }
    for m in sorted(c for c in cands if 1 <= c < n):
        if m + optimal_advances(n - m, s - 1) + optimal_advances(m, s) == target:
            return m
    # exhaustive fallback (closed-form costs, O(n) with O(1) evals)
    for m in range(1, n):
        if m + optimal_advances(n - m, s - 1) + optimal_advances(m, s) == target:
            return m
    raise AssertionError(f"no optimal split found for n={n}, s={s}")


def revolve_schedule(n: int, s: int, offset: int = 0) -> List[Action]:
    """Full optimal reversal schedule for an ``n``-step chain with ``s``
    snapshot slots.  State ``x_offset`` is assumed stored on entry (it
    occupies one of the ``s`` slots).

    The returned action stream reverses steps ``offset+n .. offset+1``.
    Executing it performs exactly ``optimal_advances(n, s)`` ADVANCE steps
    (asserted in tests) and ``n`` BACKWARD steps.
    """
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    if s < 1:
        raise ValueError(f"need s >= 1, got {s}")
    out: List[Action] = []
    _revolve(offset, offset + n, s, out)
    return out


def _revolve(b: int, e: int, s: int, out: List[Action]) -> None:
    """Reverse steps b+1..e given x_b stored, with s slots (incl. x_b's)."""
    n = e - b
    if n == 1:
        out.append(Action(Op.RESTORE, b))
        out.append(Action(Op.BACKWARD, b))
        return
    if s == 1:
        # No free slots: replay from x_b for every backward step.
        for k in range(e - 1, b - 1, -1):
            out.append(Action(Op.RESTORE, b))
            if k > b:
                out.append(Action(Op.ADVANCE, b, k))
            out.append(Action(Op.BACKWARD, k))
        return
    if n <= s:
        # Everything fits: sweep forward storing each state, then reverse.
        out.append(Action(Op.RESTORE, b))
        for k in range(b + 1, e):
            out.append(Action(Op.ADVANCE, k - 1, k))
            if k < e - 1:
                out.append(Action(Op.STORE, k))
        out.append(Action(Op.BACKWARD, e - 1))
        for k in range(e - 2, b, -1):
            out.append(Action(Op.RESTORE, k))
            out.append(Action(Op.BACKWARD, k))
            out.append(Action(Op.FREE, k))
        out.append(Action(Op.RESTORE, b))
        out.append(Action(Op.BACKWARD, b))
        return
    m = _optimal_split(n, s)
    mid = b + m
    out.append(Action(Op.RESTORE, b))
    out.append(Action(Op.ADVANCE, b, mid))
    out.append(Action(Op.STORE, mid))
    _revolve(mid, e, s - 1, out)
    out.append(Action(Op.FREE, mid))
    _revolve(b, mid, s, out)


@functools.lru_cache(maxsize=1024)
def revolve_subplan(n: int, s: int, offset: int = 0) -> tuple:
    """Immutable Revolve sub-plan for one multistage segment.

    Same action stream as :func:`revolve_schedule`, but returned as a tuple so
    it can live inside the frozen ``SegmentPlan`` IR (``repro.core.schedule``)
    and be shared across runs — segments of equal length and offset are
    planned exactly once per process.
    """
    return tuple(revolve_schedule(n, s, offset=offset))


# ---------------------------------------------------------------------------
# Schedule accounting (used by tests and the perf model)
# ---------------------------------------------------------------------------


def count_advances(schedule: List[Action]) -> int:
    return sum(a.end - a.index for a in schedule if a.op is Op.ADVANCE)


def count_backwards(schedule: List[Action]) -> int:
    return sum(1 for a in schedule if a.op is Op.BACKWARD)


def peak_slots(schedule: List[Action], initial: int = 1) -> int:
    """Max number of simultaneously live snapshot slots while executing."""
    live = initial  # the initial state of the chain is stored on entry
    peak = live
    for a in schedule:
        if a.op is Op.STORE:
            live += 1
            peak = max(peak, live)
        elif a.op is Op.FREE:
            live -= 1
    return peak


def iter_backward_indices(schedule: List[Action]) -> Iterator[int]:
    for a in schedule:
        if a.op is Op.BACKWARD:
            yield a.index
