# Port of repro/core/storage.py: tree_bytes, _freeze, RAMStorage and
# AsyncTransferEngine (the RAM Level-2 path).
"""Level-2 storage with asynchronous store / prefetch threads.

Background threads move state pytrees between the compute level (Level 1:
tensors on the card, or on the CPU) and a Level-2 store (host RAM).  Stored
pytrees are frozen to read-only numpy arrays (a bf16 leaf as its raw bits,
:class:`Bits`): ``get`` hands back the canonical copy without a defensive
deep-copy, and a caller that tries to mutate a checkpoint in place gets a
``ValueError``.

On the card the engine never makes the compute stream wait for a host
thread:

* a store of CUDA tensors is a device-to-host copy into page-locked
  buffers on a copy stream, fenced by a CUDA event; the writer thread
  waits on that event before the backend reads the buffers;
* a fused segment kernel may hand over boundaries it already wrote into
  page-locked memory (a :class:`HostTree` carrying the kernel's event);
  those buffers become the Level-2 copy itself — no second copy — and
  belong to Level 2 until the key is deleted;
* a prefetch reads the host copy and moves it host-to-device on a side
  stream from the prefetch thread; the thread waits for that copy before
  it publishes the value, so ``wait_prefetch`` returns tensors that are
  ready to use.

``delete`` invalidates any staged prefetch of the key, and staged-prefetch
bytes are counted (``staged_bytes`` / ``staged_peak_bytes``).  The disk,
compressed, tiered, journaled and sharded backends, the parameter lane and
the fault hooks come later (ROADMAP queue 1, items 8, 9, 12 and 15).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


# Copy of the base classes of repro/core/faults.py's typed taxonomy.
class StorageFault(RuntimeError):
    """Base class of every typed Level-2 storage failure."""


class WriterCrashError(StorageFault):
    """The Level-2 writer thread died with stores outstanding."""


class HostTree:
    """A pytree of host tensors plus the CUDA event after which they hold
    their final values (``ready is None``: they already do)."""

    __slots__ = ("tree", "ready")

    def __init__(self, tree: Any, ready: Any = None):
        self.tree = tree
        self.ready = ready

    def wait(self) -> Any:
        if self.ready is not None:
            self.ready.synchronize()
        return self.tree


# dtypes numpy has no type for, stored as their raw bits in an integer type
# of the same width (the JAX package stores bf16 through ml_dtypes)
_BITS = {torch.bfloat16: torch.int16}


class Bits:
    """A host Level-2 leaf of a dtype numpy cannot hold (bf16): its raw
    bits as a numpy integer array of the same width, and the torch dtype
    they encode.  ``nbytes`` counts the bits, so a bf16 state weighs 2
    bytes per element, as in the JAX package."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: torch.dtype):
        self.array = array
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return self.array.nbytes

    @property
    def shape(self):
        return self.array.shape


def _leaf_numpy(x: Any) -> Any:
    """A host view of a leaf: numpy, or :class:`Bits` for a dtype numpy
    has no type for."""
    if isinstance(x, Bits):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in _BITS:
            return Bits(x.view(_BITS[x.dtype]).numpy(), x.dtype)
        return x.numpy()
    return np.asarray(x)


def _copy(a: Any, writeable: bool = True) -> Any:
    """A deep copy of a host leaf (numpy or :class:`Bits`)."""
    if isinstance(a, Bits):
        return Bits(_copy(a.array, writeable), a.dtype)
    c = np.array(a, copy=True)
    c.setflags(write=writeable)
    return c


def _to_host(tree: Any) -> Any:
    """Deep-copy a pytree of arrays to host leaves (numpy, or :class:`Bits`
    for bf16) — detaches from Level 1."""
    return pytree.tree_map(lambda x: _copy(_leaf_numpy(x)), tree)


def _frozen(a: Any) -> bool:
    arr = a.array if isinstance(a, Bits) else a
    return isinstance(arr, np.ndarray) and not arr.flags.writeable


def _freeze(tree: Any) -> Any:
    """A *read-only* host copy of a pytree — the backend's canonical
    checkpoint.  Leaves that already are read-only (numpy arrays or
    :class:`Bits`) are the engine's own frozen views of a Level-2 buffer
    (see :func:`_frozen_views`) and are kept by reference; everything else
    is deep-copied."""
    def f(x):
        if _frozen(x):
            return x
        return _copy(_leaf_numpy(x), writeable=False)

    return pytree.tree_map(f, tree)


def _frozen_views(tree: Any) -> Any:
    """Read-only views of host tensors (no copy): the tensors become the
    Level-2 copy.  Each view's ``base`` is the writable array that shares
    the tensor's memory (:func:`_host_tensor` relies on it)."""
    def f(t):
        bits = _BITS.get(t.dtype)
        v = (t.view(bits) if bits else t).numpy().view()
        v.setflags(write=False)
        return Bits(v, t.dtype) if bits else v

    return pytree.tree_map(f, tree)


def _host_tensor(a: Any) -> torch.Tensor:
    """A CPU tensor holding a Level-2 leaf.  A frozen view of a pinned
    Level-2 buffer maps back onto that buffer without a copy (so the
    host-to-device copy stays asynchronous); anything else is copied.
    :class:`Bits` come back as their torch dtype, bit for bit."""
    if isinstance(a, Bits):
        return _host_tensor(a.array).view(a.dtype)
    a = np.asarray(a)
    base = a.base
    if (not a.flags.writeable and isinstance(base, np.ndarray)
            and base.flags.writeable and base.shape == a.shape
            and base.dtype == a.dtype and base.strides == a.strides):
        return torch.from_numpy(base)
    return torch.from_numpy(np.array(a, copy=True))


def tree_bytes(tree: Any) -> int:
    total = 0
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, Bits):
            total += x.nbytes
        else:
            total += np.asarray(x).nbytes
    return total


class RAMStorage:
    """Level-2 store in host RAM.

    ``bandwidth`` (bytes/s), if set, throttles transfers so the paper's
    T_T-vs-T_A trade-off can be reproduced deterministically on any machine.
    """

    def __init__(self, bandwidth: Optional[float] = None):
        self._data: Dict[Any, Any] = {}
        self._sizes: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self.bandwidth = bandwidth
        self.bytes_written = 0
        self.bytes_read = 0
        self.live_bytes = 0
        self.peak_bytes = 0   # high-water Level-2 footprint across the run

    def _throttle(self, nbytes: int) -> None:
        if self.bandwidth:
            time.sleep(nbytes / self.bandwidth)

    def put(self, key: Any, tree: Any) -> None:
        host = _freeze(tree)
        nb = tree_bytes(host)
        self._throttle(nb)
        with self._lock:
            self._data[key] = host
            self.bytes_written += nb
            self.live_bytes += nb - self._sizes.get(key, 0)
            self._sizes[key] = nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def get(self, key: Any) -> Any:
        """Return the stored pytree.  Leaves are read-only numpy arrays
        (the canonical checkpoint copy): mutating them raises, so the
        aliasing can never corrupt a later replay."""
        with self._lock:
            host = self._data[key]
        nb = tree_bytes(host)
        self._throttle(nb)
        with self._lock:
            self.bytes_read += nb
        return host

    def delete(self, key: Any) -> None:
        with self._lock:
            self._data.pop(key, None)
            self.live_bytes -= self._sizes.pop(key, 0)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._data

    def keys(self) -> Iterable[Any]:
        with self._lock:
            return list(self._data)


class AsyncTransferEngine:
    """Async store/prefetch around a Level-2 backend.

    * One writer thread drains a store queue (FIFO, preserves the schedule's
      store order).
    * Prefetches run one thread per outstanding key; results land in a
      staging dict that ``wait_prefetch`` joins on.

    ``device`` (optional) is where prefetched states are wanted: with a
    device, ``wait_prefetch`` returns tensors there; without one it returns
    the backend's host arrays.  Stall times are instrumented; counters and
    staged-byte accounting are guarded by the engine lock.

    ``delete(key)`` invalidates any staged prefetch of ``key`` and detaches
    its in-flight prefetch job, so a delete + re-store + prefetch sequence
    always observes the re-stored value, never a stale staged one.
    """

    def __init__(self, backend, device: Any = None):
        self.backend = backend
        self.device = None if device is None else torch.device(device)
        self._store_q: "queue.Queue" = queue.Queue()
        self._prefetched: Dict[Any, Any] = {}
        self._prefetch_events: Dict[Any, threading.Event] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._errors: list = []
        self._copy_stream = None   # D2H snapshots (CUDA only)
        self._h2d_stream = None    # prefetch uploads (CUDA only)
        self.store_stall_s = 0.0
        self.prefetch_stall_s = 0.0
        self.num_stores = 0
        self.num_prefetches = 0
        self.staged_bytes = 0       # memory held by staged prefetches
        self.staged_peak_bytes = 0  # its high-water mark across the run
        self._writer = threading.Thread(target=self._writer_loop, daemon=True)
        self._writer.start()

    # -- store path -----------------------------------------------------------
    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._store_q.get(timeout=0.05)
            except queue.Empty:
                continue
            kind = item[0]
            if kind == "stop":
                self._store_q.task_done()
                return
            try:
                if kind == "put":
                    _, key, payload = item
                    if isinstance(payload, HostTree):
                        payload = _frozen_views(payload.wait())
                    self.backend.put(key, payload)
                else:  # "delete"
                    self.backend.delete(item[1])
            except Exception as e:  # surfaced on wait_stores
                self._errors.append(e)
            finally:
                self._store_q.task_done()

    def _snapshot(self, tree: Any) -> Any:
        """Detach ``tree`` from Level 1 on the caller's thread without
        blocking it: CUDA leaves are copied into page-locked buffers on the
        copy stream (fenced by an event), host leaves are deep-copied."""
        leaves, spec = pytree.tree_flatten(tree)
        if not any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
            return _to_host(tree)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream()
        stream = self._copy_stream
        stream.wait_stream(torch.cuda.current_stream())
        host = []
        with torch.cuda.stream(stream):
            for x in leaves:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                x.record_stream(stream)
                host.append(h)
            ready = torch.cuda.Event()
            ready.record(stream)
        return HostTree(pytree.tree_unflatten(host, spec), ready)

    def store_async(self, key: Any, tree: Any) -> None:
        """Enqueue a Level-2 store of ``tree`` (a :class:`HostTree` is
        handed over as it is: its buffers become the Level-2 copy)."""
        payload = tree if isinstance(tree, HostTree) else self._snapshot(tree)
        self._store_q.put(("put", key, payload))
        with self._lock:
            self.num_stores += 1

    def delete_async(self, key: Any) -> None:
        """Like :meth:`delete`, but the backend delete rides the writer
        queue.  Staged/in-flight prefetches of the key are still
        invalidated synchronously."""
        self._invalidate(key)
        self._store_q.put(("delete", key))

    def _raise_pending(self) -> None:
        if self._errors:
            raise self._errors.pop(0)

    def _join_stores(self, timeout: Optional[float] = None) -> bool:
        """Wait until every queued store is done — without deadlocking if
        the writer thread died mid-item.  Records an error in the pending
        list on writer death or timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        q = self._store_q
        with q.all_tasks_done:
            while q.unfinished_tasks:
                if not self._writer.is_alive():
                    self._errors.append(WriterCrashError(
                        f"Level-2 writer thread died with "
                        f"{q.unfinished_tasks} store(s) outstanding"))
                    return False
                if deadline is not None and time.monotonic() >= deadline:
                    self._errors.append(RuntimeError(
                        f"timed out after {timeout:.1f}s waiting for "
                        f"{q.unfinished_tasks} outstanding Level-2 "
                        "store(s)"))
                    return False
                q.all_tasks_done.wait(timeout=0.05)
        return True

    def wait_stores(self) -> None:
        t0 = time.perf_counter()
        self._join_stores()
        self.store_stall_s += time.perf_counter() - t0
        self._raise_pending()

    # -- prefetch path --------------------------------------------------------
    def _fetch(self, key: Any) -> Any:
        """Read ``key`` from the backend and, with a device, place it there.
        A bare ``KeyError`` from a key whose store is stuck behind a dead
        writer thread is re-raised as a :class:`WriterCrashError`."""
        try:
            val = self.backend.get(key)
        except StorageFault:
            raise
        except Exception as e:
            if not self._writer.is_alive() and not self._stop.is_set():
                raise WriterCrashError(
                    f"Level-2 writer thread died before {key!r} was "
                    f"readable ({self._store_q.unfinished_tasks} store(s) "
                    "outstanding)") from e
            raise
        if self.device is None:
            return val
        host = pytree.tree_map(_host_tensor, val)
        if self.device.type != "cuda":
            return pytree.tree_map(lambda t: t.to(self.device), host)
        if self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._h2d_stream):
            out = pytree.tree_map(
                lambda t: t.to(self.device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(self._h2d_stream)
        done.synchronize()   # this (prefetch) thread waits, never compute
        return out

    def prefetch_async(self, key: Any) -> None:
        with self._lock:
            if key in self._prefetched or key in self._prefetch_events:
                return
            ev = threading.Event()
            self._prefetch_events[key] = ev
            self.num_prefetches += 1

        def _job() -> None:
            # The staged result (and any error) is only published while this
            # job's event is still the registered one for the key: a delete
            # (or delete + re-store + new prefetch) in the meantime detaches
            # this job, so its value can never be observed stale.
            try:
                val = self._fetch(key)
                with self._lock:
                    if self._prefetch_events.get(key) is ev:
                        self._prefetched[key] = val
                        self.staged_bytes += tree_bytes(val)
                        self.staged_peak_bytes = max(self.staged_peak_bytes,
                                                     self.staged_bytes)
            except Exception as e:
                with self._lock:
                    if self._prefetch_events.get(key) is ev:
                        self._errors.append(e)
            finally:
                ev.set()

        threading.Thread(target=_job, daemon=True).start()

    def _adopt(self, val: Any) -> Any:
        """Hand prefetched CUDA tensors to the compute stream (their memory
        was allocated on the upload stream)."""
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream()
            for t in pytree.tree_leaves(val):
                t.record_stream(stream)
        return val

    def wait_prefetch(self, key: Any) -> Any:
        with self._lock:
            ev = self._prefetch_events.get(key)
        if ev is None:  # never prefetched: demand-fetch (counts as full stall)
            # Surface any async error first — a failed store means the key
            # may be missing and a bare KeyError would hide the real cause.
            self._raise_pending()
            t0 = time.perf_counter()
            val = self._fetch(key)
            self.prefetch_stall_s += time.perf_counter() - t0
            self._raise_pending()
            return self._adopt(val)
        t0 = time.perf_counter()
        ev.wait()
        self.prefetch_stall_s += time.perf_counter() - t0
        self._raise_pending()
        _MISSING = object()
        with self._lock:
            if self._prefetch_events.get(key) is ev:
                self._prefetch_events.pop(key)
            val = self._prefetched.pop(key, _MISSING)
            if val is not _MISSING:
                self.staged_bytes -= tree_bytes(val)
        if val is _MISSING:
            # the staged value was invalidated (delete raced this wait):
            # fall back to a demand fetch of the current backend state
            t0 = time.perf_counter()
            val = self._fetch(key)
            self.prefetch_stall_s += time.perf_counter() - t0
            self._raise_pending()
        return self._adopt(val)

    def _invalidate(self, key: Any) -> None:
        with self._lock:
            self._prefetch_events.pop(key, None)   # detaches in-flight jobs
            dropped = self._prefetched.pop(key, None)
            if dropped is not None:
                self.staged_bytes -= tree_bytes(dropped)

    def delete(self, key: Any) -> None:
        """Drop ``key`` from Level 2 *and* invalidate any staged or
        in-flight prefetch of it — a later re-store + prefetch must observe
        the new value, never the stale staging entry."""
        self._invalidate(key)
        self.backend.delete(key)

    def close(self) -> None:
        """Drain outstanding stores (bounded — never deadlocks on a dead
        writer thread), stop the writer, drop staged prefetches that were
        never waited on (and their events), and re-raise any pending
        transfer error so failures can't vanish silently at shutdown.
        In-flight fetch jobs are joined (bounded) before the staging dicts
        are cleared, so their errors are not dropped."""
        self._join_stores(timeout=10.0)
        self._stop.set()
        self._store_q.put(("stop",))   # wake the writer immediately
        self._writer.join(timeout=2.0)
        with self._lock:
            events = list(self._prefetch_events.values())
        for ev in events:
            ev.wait(timeout=2.0)
        with self._lock:
            self._prefetched.clear()
            self._prefetch_events.clear()
            self.staged_bytes = 0
        self._raise_pending()
