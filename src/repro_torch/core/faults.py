# Copy of repro/core/faults.py (the port imports nothing of repro).
"""Fault injection for the Level-2 storage stack (chaos testing).

A multi-hour reverse sweep dies in a handful of well-defined ways: the
Level-2 writer thread is killed mid-store (OOM-killer, preemption), a
demand fetch fails (evicted page, flaky SSD), a spilled record is torn by
a crash mid-write, or bytes rot on disk and trip a checksum.  This module
makes every one of those injectable *deterministically*, so the
crash-consistency machinery (``JournaledStorage`` + ``resume_from=``) can
be tested as a property: a faulted run either completes with gradients
bit-identical to the fault-free run, or raises a typed
:class:`StorageFault` — and a resume afterwards always reproduces the
fault-free gradient exactly.

Injection is a *zero-overhead-when-disabled* hook: ``AsyncTransferEngine``
and ``JournaledStorage`` read the module-global injector once at
construction (``faults.inject(plan)`` context manager, or an explicit
``faults=`` argument) and each hook site is a single ``is not None`` test.
Production code paths never pay more than that.

Typed fault taxonomy (all subclass :class:`StorageFault`, itself a
``RuntimeError`` so retry wrappers keyed on RuntimeError keep working):

* :class:`WriterCrashError` — the Level-2 writer thread died with stores
  outstanding (detected at join/demand-fetch time).
* :class:`TornRecordError` — a journal record was truncated mid-write
  (reported by the journal scanner; the torn *tail* of a crash is
  repaired silently, a torn interior is an error).
* :class:`ChecksumError` — a complete record whose payload fails its
  CRC (bit rot / injected flip).
* :class:`InjectedFault` — the generic injected transfer failure
  (demand-fetch / put faults).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Optional


class StorageFault(RuntimeError):
    """Base class of every typed Level-2 storage failure.

    Subclasses ``RuntimeError`` so retry wrappers keyed on RuntimeError
    treat storage faults as retryable without modification.
    """


class WriterCrashError(StorageFault):
    """The Level-2 writer thread died with work outstanding."""


class TornRecordError(StorageFault):
    """A journal record was cut short by a crash mid-write."""


class ChecksumError(StorageFault):
    """A journal record's payload does not match its CRC."""


class InjectedFault(StorageFault):
    """A deliberately injected transfer failure (tests only)."""


class WriterKilled(Exception):
    """Raised *inside* the writer thread to simulate abrupt death.

    Deliberately NOT a :class:`StorageFault`: nothing downstream should
    ever observe it — the writer loop catches it and returns without
    marking the queue item done, exactly as if the thread had been killed
    by the OS.  (If it escapes on a synchronous code path, that is a test
    wiring bug, and the loud generic exception is the right outcome.)
    """


@dataclass(frozen=True)
class FaultPlan:
    """Declarative description of which fault to inject and when.

    All counters are 0-based and count events of their own kind across the
    lifetime of one :class:`FaultInjector` (i.e. one ``inject()`` block).

    * ``kill_writer_at_store`` — the writer thread dies immediately before
      executing its ``k``-th queued store (the item is left un-done, so
      joins report :class:`WriterCrashError`).
    * ``fail_get_at`` — the ``k``-th engine-level fetch (prefetch job or
      demand fetch) raises :class:`InjectedFault` instead of reading.
    * ``truncate_journal_at_store`` — the ``k``-th journaled STORE record
      is torn in half on disk and the writing thread dies on the spot
      (crash mid-``write(2)``).
    * ``flip_byte_at_store`` — one payload byte of the ``k``-th journaled
      STORE record is flipped *after* it was written and fsynced (silent
      bit rot: the run continues; the corruption trips
      :class:`ChecksumError` when the record is next read or scanned).
    """

    kill_writer_at_store: Optional[int] = None
    fail_get_at: Optional[int] = None
    truncate_journal_at_store: Optional[int] = None
    flip_byte_at_store: Optional[int] = None
    # Event-driven preemption: while the event is set, the writer thread
    # dies at its next store (same observable outcome as
    # ``kill_writer_at_store``, but triggered asynchronously by a
    # scheduler instead of at a precomputed count).  A scheduler uses
    # this to preempt a running offloaded train step at a clean journal
    # boundary: the run raises WriterCrashError, the journal keeps every
    # fsynced segment, and ``resume_from=`` replays bit-identically.
    preempt_on: Optional[threading.Event] = None

    def __post_init__(self):
        for name in ("kill_writer_at_store", "fail_get_at",
                     "truncate_journal_at_store", "flip_byte_at_store"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")


class FaultInjector:
    """Counts events and fires the faults a :class:`FaultPlan` asks for.

    Thread-safe: hooks are called from the writer thread, prefetch threads
    and the caller thread concurrently.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self.writer_stores = 0      # stores seen by the writer thread
        self.gets = 0               # engine-level fetches
        self.journal_stores = 0     # STORE records appended to a journal
        self.fired: list = []       # (kind, index) of every injected fault

    def _count(self, field: str) -> int:
        with self._lock:
            k = getattr(self, field)
            setattr(self, field, k + 1)
            return k

    def _fire(self, kind: str, k: int) -> None:
        with self._lock:
            self.fired.append((kind, k))

    # -- hook sites (each guarded by `injector is not None` at the caller) --
    def on_writer_store(self, key) -> None:
        k = self._count("writer_stores")
        if k == self.plan.kill_writer_at_store:
            self._fire("kill_writer", k)
            raise WriterKilled(
                f"injected writer death at store {k} (key {key!r})")
        if self.plan.preempt_on is not None and self.plan.preempt_on.is_set():
            self._fire("preempt", k)
            raise WriterKilled(
                f"preemption requested; writer dying at store {k} "
                f"(key {key!r})")

    def on_get(self, key) -> None:
        k = self._count("gets")
        if k == self.plan.fail_get_at:
            self._fire("fail_get", k)
            raise InjectedFault(
                f"injected Level-2 fetch failure at get {k} (key {key!r})")

    def on_journal_store(self, journal, start: int, end: int) -> None:
        """Called by ``JournaledStorage`` right after a STORE record has
        been written and fsynced; ``[start, end)`` is the record's extent.
        May mutate the journal file through the two private fault hooks the
        journal exposes, and/or kill the writing thread."""
        k = self._count("journal_stores")
        if k == self.plan.flip_byte_at_store:
            self._fire("flip_byte", k)
            journal.debug_flip_byte(end - 1)   # last payload byte: CRC trips
        if k == self.plan.truncate_journal_at_store:
            self._fire("truncate", k)
            journal.debug_truncate(start + (end - start) // 2)
            raise WriterKilled(
                f"injected crash tearing journal record {k}")


# ---------------------------------------------------------------------------
# module-global injector (read once at engine/backend construction)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    """The currently installed injector (``None`` almost always)."""
    return _ACTIVE


@contextmanager
def inject(plan: FaultPlan) -> Iterator[FaultInjector]:
    """Install a fault plan for the duration of the block.

    Engines and journaled backends constructed inside the block pick the
    injector up; ones constructed outside are unaffected (zero overhead
    when disabled — the hook is a single ``is not None`` test).
    """
    global _ACTIVE
    injector = FaultInjector(plan)
    prev, _ACTIVE = _ACTIVE, injector
    try:
        yield injector
    finally:
        _ACTIVE = prev


def is_storage_fault(err: BaseException) -> bool:
    """True if ``err`` is (or transitively wraps) a typed StorageFault.

    An exception re-raised by a wrapper may keep only the original
    type name in its message, so this matches both the ``__cause__``/``__context__`` chain
    and the text — the predicate retry/preemption handlers use to decide
    whether a failed step is resumable."""
    seen = set()
    e: Optional[BaseException] = err
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, StorageFault):
            return True
        e = e.__cause__ or e.__context__
    return any(name in str(err) for name in
               ("StorageFault", "WriterCrashError", "ChecksumError",
                "TornRecordError", "InjectedFault"))
