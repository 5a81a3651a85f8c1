# Port of repro/core/storage.py: tree_bytes, _freeze, _freeze_in_place,
# RAMStorage, DiskStorage, CompressedStorage, TieredStorage,
# NamespacedStorage, JournaledStorage, register_backend/make_backend and
# AsyncTransferEngine (with its fault hooks, cursor_async and the parameter
# lane: prefetch_params_async, wait_param).
"""Level-2 storage with asynchronous store / prefetch threads.

Background threads move state pytrees between the compute level (Level 1:
tensors on the card, or on the CPU) and a Level-2 store.  Stored pytrees
are frozen to read-only numpy arrays (a bf16 leaf as its raw bits,
:class:`Bits`): ``get`` hands back the canonical copy without a defensive
deep-copy, and a caller that tries to mutate a checkpoint in place gets a
``ValueError``.

Backends speak one protocol (``put``, ``get``, ``delete``, ``__contains__``,
``keys``) and are built by name with ``make_backend("ram" | "disk" |
"compressed" | "tiered", ...)`` (``register_backend`` adds kinds):

* :class:`RAMStorage` — host RAM;
* :class:`DiskStorage` — one pickle file per key, published with
  ``os.replace`` (no fsync: the page cache may hold it);
* :class:`CompressedStorage` — int8 absmax quantisation of float leaves
  (:mod:`repro_torch.distributed.compression`) over an inner store; bf16
  and integer leaves stay raw, bit for bit;
* :class:`TieredStorage` — a fast tier under a byte budget that
  write-behind spills to a slow tier, with plan-aware (Belady) eviction,
  demand promotion, tenant quotas and namespaces
  (:class:`NamespacedStorage`);
* :class:`JournaledStorage` — a write-ahead journal
  (:mod:`repro_torch.core.journal`) over any of them
  (``make_backend(kind, journal=directory)``): every store, delete and
  plan cursor is a CRC'd record, forced to disk once per segment, so a
  crashed run resumes from its last durable boundary.

On the card the engine never makes the compute stream wait for a host
thread:

* a store of CUDA tensors is a device-to-host copy into page-locked
  buffers on a copy stream, fenced by a CUDA event; the writer thread
  waits on that event before the backend reads the buffers;
* a fused segment kernel may hand over boundaries it already wrote into
  page-locked memory (a :class:`HostTree` carrying the kernel's event);
  those buffers become the Level-2 copy itself — no second copy — and
  belong to Level 2 until the key is deleted (a tiered fast tier keeps
  them by reference; an eviction drops them once the slow tier holds its
  own copy).  Each must own its storage, so Level 2 holds exactly the
  bytes it counts.  A captured fused segment writes into a slot of a
  :class:`PinnedSlotPool` (grown on demand, reused from call to call),
  which returns to the pool once nothing holds it any more;
* a prefetch reads the host copy and moves it host-to-device on a side
  stream from the prefetch thread (a leaf that is not a view of a
  page-locked Level-2 buffer — a disk read, a decoded or promoted state —
  is first copied into page-locked memory there); the thread waits for
  that copy before it publishes the value, so ``wait_prefetch`` returns
  tensors that are ready to use.

``delete`` invalidates any staged prefetch of the key, and staged-prefetch
bytes are counted (``staged_bytes`` / ``staged_peak_bytes``).  The engine's
fault hooks (:mod:`repro_torch.core.faults`) cost one ``is not None`` test
when no fault plan is installed.

The engine's *parameter lane* (``prefetch_params_async`` / ``wait_param``)
moves streamed parameter blobs (a MoE chain's expert weights,
``executor.ParamStream``) the same way, one segment's batch a job on the
prefetch thread, read through a tiered store's non-promoting ``peek``.
The sharded backends come later (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import faults as _faults
from repro_torch.core import journal as _journal
from repro_torch.core.faults import (ChecksumError, StorageFault,
                                     WriterCrashError, WriterKilled)
from repro_torch.core.journal import RecoveredRun
from repro_torch.distributed.compression import dequantize_np, quantize_np


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
    the tensor's memory (:func:`_host_tensor` relies on it).

    A tensor kept this way must own its storage: a slice of a larger buffer
    would keep the whole buffer alive while Level 2 counts only the slice,
    so it raises ``ValueError``."""
    def f(t):
        held = t.untyped_storage().nbytes()
        if held > t.numel() * t.element_size():
            raise ValueError(
                f"a Level-2 leaf of {t.numel() * t.element_size()} bytes "
                f"would keep a storage of {held} bytes alive; hand over "
                "buffers that own their storage")
        bits = _BITS.get(t.dtype)
        v = (t.view(bits) if bits else t).numpy().view()
        v.setflags(write=False)
        return Bits(v, t.dtype) if bits else v

    return pytree.tree_map(f, tree)


def _freeze_in_place(tree: Any) -> Any:
    """Mark a *freshly materialised* pytree read-only without copying
    (pickle or decode output, or leaves already frozen): copying would
    only add to the transfer the caller is hiding."""
    def f(x):
        a = x.array if isinstance(x, Bits) else x
        if a.flags.writeable:
            a.setflags(write=False)
        return x

    return pytree.tree_map(f, tree)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _host_tensor(a: Any, pin: bool = False) -> torch.Tensor:
    """A CPU tensor holding a Level-2 leaf.  A frozen view of a Level-2
    buffer maps back onto that buffer without a copy (a page-locked one
    keeps the host-to-device copy asynchronous); anything else is copied,
    into page-locked memory when ``pin`` (the upload to the card).
    :class:`Bits` come back as their torch dtype, bit for bit."""
    if isinstance(a, Bits):
        return _host_tensor(a.array, pin).view(a.dtype)
    a = np.asarray(a)
    base = a.base
    if (not a.flags.writeable and isinstance(base, np.ndarray)
            and base.flags.writeable and base.shape == a.shape
            and base.dtype == a.dtype and base.strides == a.strides):
        t = torch.from_numpy(base)
        if not pin or t.is_pinned():
            return t
    if pin:
        t = torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                        pin_memory=True)
        t.numpy()[...] = a
        return t
    return torch.from_numpy(np.array(a, copy=True))


def page_locked_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` in page-locked memory of exactly its size that
    owns its storage (Level 2 keeps it without a copy, and an upload from it
    is asynchronous): a pageable buffer registered with the CUDA driver
    (``cudaHostRegister``) and unregistered when the last reference to it
    goes.  The caching page-locked allocator would round each buffer up to
    a power of two.

    The memory is a numpy array's, and the registration ends with that
    array, which the tensor's storage (and every view or numpy array of it)
    keeps alive: a torch tensor's Python object may be dropped and made
    anew while its storage lives on."""
    bits = _BITS.get(t.dtype)
    arr = np.empty(tuple(t.shape),
                   torch.empty(0, dtype=bits or t.dtype).numpy().dtype)
    h = torch.from_numpy(arr)
    if bits:
        h = h.view(t.dtype)
    h.copy_(t)
    ptr, nbytes = arr.ctypes.data, arr.nbytes
    if nbytes:
        cudart = torch.cuda.cudart()
        err = cudart.cudaHostRegister(ptr, nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} B failed "
                               f"({err})")
        weakref.finalize(arr, cudart.cudaHostUnregister, ptr)
    return h


class PinnedSlotPool:
    """Page-locked Level-2 slots of one state shape, reused from segment to
    segment and from call to call: where a captured fused segment writes
    its segment-entry state (and, in two scratch slots, its later chunk
    entries).

    ``take()`` hands out a free slot as fresh CPU tensors (one per leaf of
    ``shapes``) over the slot's memory, each owning a storage of its own
    that wraps the slot: Level 2 keeps them without a copy, as it keeps
    any page-locked buffer (:func:`_frozen_views`).  The slot goes back to
    the pool when the last reference to those tensors (and to any view or
    numpy array of them) is gone: a store's delete, a tiered store's
    eviction once the slow tier holds its copy, a disk store's put (it
    pickles a copy), the prefetch thread's upload (it waits for the copy
    before it drops the buffer); never while anything can still read it.
    The kernel's writes are fenced by the segment's ``ready`` event, which
    every reader waits for.

    ``take()`` allocates one more slot only when none is free (counted in
    ``grown``), so the pool settles at the most slots a run holds at once
    (what its Level-2 store keeps plus what is in flight) during its first
    call, and later calls of the same run allocate nothing;
    ``reserve(count)`` allocates up to ``count`` slots ahead.  ``in_use``:
    slots handed out and not yet back; ``peak``: its high-water mark since
    :meth:`reset_peak`.  ``scratch``: two slots no one reads, for chunk
    entries past the first."""

    def __init__(self, shapes, dtype: torch.dtype, pin: bool = True):
        self.shapes = [tuple(sh) for sh in shapes]
        self.dtype = dtype
        self.pin = pin
        self._slots: list = []
        self._free: list = []
        self._lock = threading.Lock()
        self.grown = 0
        self.takes = 0
        self.peak = 0
        self.scratch = [self._new() for _ in range(2)]

    def _new(self):
        return tuple(torch.empty(sh, dtype=self.dtype, pin_memory=self.pin)
                     for sh in self.shapes)

    @property
    def slot_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.scratch[0])

    @property
    def size(self) -> int:
        """Slots allocated (the scratch pair not counted)."""
        return len(self._slots)

    @property
    def free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return len(self._slots) - len(self._free)

    def reset_peak(self) -> None:
        with self._lock:
            self.peak = len(self._slots) - len(self._free)

    def reserve(self, count: int) -> None:
        with self._lock:
            while len(self._slots) < count:
                self._slots.append(self._new())
                self._free.append(len(self._slots) - 1)

    def take(self):
        """``(index, leaves)``: a free slot and fresh tensors over it."""
        with self._lock:
            if self._free:
                i = self._free.pop()
            else:
                self._slots.append(self._new())
                i = len(self._slots) - 1
                self.grown += 1
            self.takes += 1
            self.peak = max(self.peak, len(self._slots) - len(self._free))
        left = [len(self.shapes)]

        def released():
            with self._lock:
                left[0] -= 1
                if left[0] == 0:
                    self._free.append(i)

        leaves = []
        for t in self._slots[i]:
            base = t.numpy()   # a fresh array over the slot's memory
            weakref.finalize(base, released)
            leaves.append(torch.from_numpy(base))
        return i, tuple(leaves)

    def leaves(self, i: int):
        """The pool's own tensors of slot ``i`` (for the kernels'
        destinations; never handed to Level 2)."""
        return self._slots[i]


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


class DiskStorage:
    """Level-2 store on disk (the paper's DRAM->SSD platform): one pickle
    file per key, written and read by the background threads through the
    filesystem API and published with ``os.replace``.  There is no fsync
    (as in the JAX package): a put may live in the page cache.  ``get``
    returns fresh arrays."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._keys: Dict[Any, str] = {}
        self._sizes: Dict[Any, int] = {}
        self.bytes_written = 0
        self.bytes_read = 0
        self.live_bytes = 0
        self.peak_bytes = 0   # high-water Level-2 footprint across the run

    def _path(self, key: Any) -> str:
        return os.path.join(self.directory, f"ckpt_{key}.pkl")

    def put(self, key: Any, tree: Any) -> None:
        # host views, no copy: pickling copies the bytes into the file
        host = pytree.tree_map(_leaf_numpy, tree)
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic publish
        nb = tree_bytes(host)
        with self._lock:
            self._keys[key] = path
            self.bytes_written += nb
            self.live_bytes += nb - self._sizes.get(key, 0)
            self._sizes[key] = nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def get(self, key: Any) -> Any:
        with self._lock:
            path = self._keys[key]
        with open(path, "rb") as f:
            host = pickle.load(f)
        with self._lock:
            self.bytes_read += tree_bytes(host)
        return host

    def delete(self, key: Any) -> None:
        with self._lock:
            path = self._keys.pop(key, None)
            self.live_bytes -= self._sizes.pop(key, 0)
        if path and os.path.exists(path):
            os.remove(path)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._keys

    def keys(self) -> Iterable[Any]:
        with self._lock:
            return list(self._keys)


class CompressedStorage:
    """Level-2 wrapper that int8-quantises float leaves before handing the
    tree to an inner backend (host RAM by default, disk when ``directory``
    is given).

    Each float array of at least ``min_bytes`` becomes an int8 payload, one
    f32 scale and a 0-d exemplar of its dtype (~4x smaller); integer leaves,
    small arrays and bf16 (:class:`Bits`, whose numpy dtype is an integer
    type, as ``ml_dtypes.bfloat16``'s kind ``'V'`` keeps the JAX package's
    bf16 raw) are stored raw.  Decoding restores the original dtype; the
    error per leaf is bounded by ``compression.quantization_error_bound``.
    Checkpoint states are replay starting points, so this trades a bounded
    precision loss for ~4x Level-2 capacity.
    """

    def __init__(self, inner: Any = None, directory: Optional[str] = None,
                 min_bytes: int = 256):
        if inner is None:
            inner = DiskStorage(directory) if directory else RAMStorage()
        self.inner = inner
        self.min_bytes = min_bytes
        # guards this wrapper's fields (the inner backend has its own):
        # put runs on the writer thread while callers read the counters
        self._lock = threading.Lock()
        self._raw_bytes = 0         # pre-compression payload
        self._treedefs: Dict[Any, Any] = {}   # key -> original structure

    # -- per-leaf codec -------------------------------------------------------
    # A quantised leaf is the tuple (q_int8, scale_f32, dtype_exemplar);
    # every other leaf is an array (or Bits), so the tuple tag is
    # unambiguous.
    def _encode_leaf(self, x: Any) -> Any:
        arr = _leaf_numpy(x)
        if isinstance(arr, Bits):
            return arr
        if arr.dtype.kind == "f" and arr.nbytes >= self.min_bytes:
            q, scale = quantize_np(arr)
            return (q, scale, np.zeros((), arr.dtype))
        # a copy: a raw leaf must not keep the caller's buffer (a pooled
        # page-locked slot) alive
        return np.array(arr, copy=True)

    @staticmethod
    def _decode_leaf(enc: Any) -> Any:
        if not isinstance(enc, tuple):
            return enc
        q, scale, exemplar = enc
        return np.asarray(dequantize_np(q, scale), dtype=exemplar.dtype)

    # -- backend protocol -----------------------------------------------------
    def put(self, key: Any, tree: Any) -> None:
        leaves, treedef = pytree.tree_flatten(tree)
        nb = tree_bytes(leaves)
        with self._lock:
            self._raw_bytes += nb
            self._treedefs[key] = treedef
        payload = [self._encode_leaf(x) for x in leaves]
        # the pickled structure rides along as a trailing uint8 leaf, so a
        # store re-read without this instance's map can still unflatten
        payload.append(np.frombuffer(
            pickle.dumps(treedef, protocol=pickle.HIGHEST_PROTOCOL),
            dtype=np.uint8))
        self.inner.put(key, payload)

    def get(self, key: Any) -> Any:
        encs = self.inner.get(key)
        encs, td_arr = encs[:-1], encs[-1]
        with self._lock:
            treedef = self._treedefs.get(key)
        if treedef is None:
            treedef = pickle.loads(np.asarray(td_arr).tobytes())
            with self._lock:
                self._treedefs[key] = treedef
        return pytree.tree_unflatten(
            [self._decode_leaf(x) for x in encs], treedef)

    def delete(self, key: Any) -> None:
        self.inner.delete(key)
        with self._lock:
            self._treedefs.pop(key, None)

    def __contains__(self, key: Any) -> bool:
        return key in self.inner

    def keys(self) -> Iterable[Any]:
        return self.inner.keys()

    @property
    def raw_bytes(self) -> int:
        """Pre-compression payload bytes."""
        with self._lock:
            return self._raw_bytes

    @property
    def bytes_written(self) -> int:  # compressed (on-the-wire) accounting
        return self.inner.bytes_written

    @property
    def bytes_read(self) -> int:
        return self.inner.bytes_read

    @property
    def live_bytes(self) -> int:
        return self.inner.live_bytes

    @property
    def peak_bytes(self) -> int:
        return self.inner.peak_bytes

    def __getattr__(self, name: str):
        # Pass unknown verbs through to the inner backend (journal verbs
        # for a hand-built CompressedStorage(inner=JournaledStorage(...))
        # composition, instrumentation attributes otherwise).
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)


class TieredStorage:
    """Capacity-bounded two-tier Level-2 store: a fast tier (host RAM,
    ``capacity_bytes``) over a slow tier (disk when ``directory`` is given,
    else a RAM stand-in; ``compress=True`` int8-quantises the slow copies).

    ``put`` lands in the fast tier and, when the budget would overflow,
    write-behind evicts the coldest resident to the slow tier.  Cold is
    plan-aware: :meth:`set_plan` records the plan's future access order,
    so the victim is always the key whose next use is farthest away
    (Belady's rule; for a ``SegmentPlan``, the smallest begin).  Keys
    outside the plan (autotune probes) evict first; with no plan, eviction
    is FIFO.

    ``get`` serves fast-tier hits by reference (frozen read-only arrays)
    and *promotes* slow-tier hits back into the fast tier (the executor
    also promotes ahead of need, :meth:`plan_prefetch_distance`).  Promoted
    entries are clean: evicting them again drops the fast copy without a
    second slow-tier write.  ``peek`` reads without promoting.

    ``fast_live_bytes <= capacity_bytes`` at every instant outside the
    lock: a state larger than the whole budget bypasses the fast tier.
    Tenant quotas (:meth:`set_quota`) and namespaces
    (:meth:`register_namespace`, keys ``(namespace, key)``) bound a
    tenant's or a run's share of the fast tier the same way.
    """

    def __init__(self, capacity_bytes: int, slow: Any = None,
                 directory: Optional[str] = None, compress: bool = False,
                 bandwidth: Optional[float] = None):
        if capacity_bytes <= 0:
            raise ValueError(
                f"need capacity_bytes > 0, got {capacity_bytes}")
        if slow is None:
            slow = DiskStorage(directory) if directory else RAMStorage()
        if compress:
            slow = CompressedStorage(inner=slow)
        self.slow = slow
        self.capacity_bytes = int(capacity_bytes)
        self.bandwidth = bandwidth          # fast-tier throttle (bytes/s)
        self._lock = threading.Lock()
        self._fast: Dict[Any, Any] = {}
        self._sizes: Dict[Any, int] = {}    # sizes of fast-resident entries
        self._clean: set = set()            # fast entries also valid in slow
        # Write-behind: _writing holds the latest pending payload per key;
        # _wb_active the keys some thread is draining (one drainer per key
        # keeps a key's slow-tier writes ordered, so an old eviction never
        # lands on top of a newer one); _wb_deleted tombstones keys deleted
        # while their writeback was in flight.
        self._writing: Dict[Any, Any] = {}
        self._wb_active: set = set()
        self._wb_deleted: set = set()
        self._seq: Dict[Any, int] = {}      # insertion order (FIFO fallback)
        self._next_seq = 0
        self._distance: Dict[Any, int] = {}  # plan key -> reverse-use distance
        # tenant quotas and namespace caps on the fast tier
        self._quota: Dict[Any, int] = {}        # tenant -> fast byte quota
        self._ns_tenant: Dict[Any, Any] = {}    # namespace -> tenant
        self._ns_cap: Dict[Any, int] = {}       # namespace -> fast byte cap
        self.tenant_fast_bytes: Dict[Any, int] = {}
        self.tenant_fast_peak: Dict[Any, int] = {}
        self.ns_fast_bytes: Dict[Any, int] = {}
        self.ns_fast_peak: Dict[Any, int] = {}
        # -- instrumentation ---------------------------------------------------
        self.fast_live_bytes = 0
        self.fast_peak_bytes = 0   # high-water fast tier: obeys capacity
        self.evictions = 0         # fast -> slow write-behind spills
        self.promotions = 0        # slow -> fast promotions
        self.fast_hits = 0
        self.slow_hits = 0
        self.bytes_written = 0     # total put payload (fast + direct-to-slow)
        self.bytes_read = 0
        self.untracked_keys = 0    # resident keys the last set_plan() missed
        self._peak_total = 0

    def _throttle(self, nbytes: int) -> None:
        if self.bandwidth:
            time.sleep(nbytes / self.bandwidth)

    # -- plan awareness -------------------------------------------------------
    def set_plan(self, plan: Any) -> None:
        """Record the future access order of an offload plan:
        ``distance[key]`` = accesses until ``key`` is needed (0 = first);
        the eviction victim maximises it.  Takes anything with
        ``distances() -> {key: rank}`` (a ``ResourceAccessPlan``) or a
        ``SegmentPlan`` (``reverse_access_order()``).  Resident keys the
        new plan does not mention fall back to FIFO and evict first; each
        call counts them into ``untracked_keys``."""
        dist_fn = getattr(plan, "distances", None)
        if dist_fn is not None:
            dist = dict(dist_fn())
        else:
            dist = {key: d
                    for d, key in enumerate(plan.reverse_access_order())}
        with self._lock:
            self._distance = dist
            held = set(self._fast) | set(self._writing)
        held |= set(self.slow.keys())
        with self._lock:
            self.untracked_keys += sum(1 for k in held if k not in dist)

    def plan_prefetch_distance(self, plan: Any) -> int:
        """Segments of lead the reverse sweep should promote boundaries
        with (the executor's prefetch depth): ``SegmentPlan.tier_plan`` at
        the observed boundary-state size; with nothing resident to size
        from, spill is assumed."""
        if not hasattr(plan, "boundaries"):
            # a ResourceAccessPlan: no segments; no spill -> 1, else 2
            resident, spilled, _ = plan.tier_residency(self.capacity_bytes)
            n_keys = len(plan.keys())
            return 1 if spilled == 0 else min(max(n_keys, 1), 2)
        m = len(plan.boundaries())
        with self._lock:
            sizes = [self._sizes.get(k) for k in plan.boundaries()]
            state = max((s for s in sizes if s is not None), default=0)
        if state == 0:
            return min(m, 2) if m else 1
        return plan.tier_plan(self.capacity_bytes,
                              state).prefetch_distance

    # -- multi-tenant quotas --------------------------------------------------
    def set_quota(self, tenant: Any, max_fast_bytes: int) -> None:
        """Cap ``tenant``'s fast-tier residency at ``max_fast_bytes`` (a
        state larger than the quota bypasses the fast tier)."""
        if max_fast_bytes <= 0:
            raise ValueError(
                f"need max_fast_bytes > 0, got {max_fast_bytes}")
        with self._lock:
            self._quota[tenant] = int(max_fast_bytes)
            self.tenant_fast_bytes.setdefault(tenant, 0)
            self.tenant_fast_peak.setdefault(tenant, 0)

    def register_namespace(self, namespace: Any, tenant: Any,
                           max_fast_bytes: Optional[int] = None) -> None:
        """Charge keys ``(namespace, *)`` to ``tenant``'s quota;
        ``max_fast_bytes`` also caps this namespace's own residency."""
        with self._lock:
            if tenant not in self._quota:
                raise KeyError(f"unknown tenant {tenant!r}: set_quota first")
            self._ns_tenant[namespace] = tenant
            if max_fast_bytes is not None:
                if max_fast_bytes <= 0:
                    raise ValueError(
                        f"need max_fast_bytes > 0, got {max_fast_bytes}")
                self._ns_cap[namespace] = int(max_fast_bytes)
            self.ns_fast_bytes.setdefault(namespace, 0)
            self.ns_fast_peak.setdefault(namespace, 0)

    def _owner_locked(self, key: Any):
        """(namespace, tenant) charged for ``key``; (None, None) for keys
        of no registered namespace."""
        if isinstance(key, tuple) and len(key) >= 2:
            tenant = self._ns_tenant.get(key[0])
            if tenant is not None:
                return key[0], tenant
        return None, None

    def _account_fast_add_locked(self, key: Any, nb: int) -> None:
        ns, t = self._owner_locked(key)
        if t is None:
            return
        self.tenant_fast_bytes[t] += nb
        self.ns_fast_bytes[ns] += nb

    def _note_fast_peaks_locked(self) -> None:
        # peaks observe the state after eviction, as the outside world can
        # read it (a put is over budget only inside the lock)
        self.fast_peak_bytes = max(self.fast_peak_bytes,
                                   self.fast_live_bytes)
        for t, b in self.tenant_fast_bytes.items():
            self.tenant_fast_peak[t] = max(self.tenant_fast_peak[t], b)
        for ns, b in self.ns_fast_bytes.items():
            self.ns_fast_peak[ns] = max(self.ns_fast_peak[ns], b)

    def _account_fast_drop_locked(self, key: Any, nb: int) -> None:
        ns, t = self._owner_locked(key)
        if t is None:
            return
        self.tenant_fast_bytes[t] -= nb
        self.ns_fast_bytes[ns] -= nb

    def update_plan(self, namespace: Any, distances: Dict[Any, int]) -> None:
        """Replace one namespace's Belady distances in the shared order,
        leaving the other namespaces' keys plan-aware."""
        def _ours(k):
            return isinstance(k, tuple) and len(k) >= 2 and k[0] == namespace
        with self._lock:
            self._distance = {k: v for k, v in self._distance.items()
                              if not _ours(k)}
            self._distance.update(distances)

    def drop_namespace(self, namespace: Any) -> int:
        """Delete every key of ``namespace`` from both tiers; returns how
        many."""
        dropped = 0
        for k in list(self.keys()):
            if isinstance(k, tuple) and len(k) >= 2 and k[0] == namespace:
                self.delete(k)
                dropped += 1
        with self._lock:
            self._distance = {
                k: v for k, v in self._distance.items()
                if not (isinstance(k, tuple) and len(k) >= 2
                        and k[0] == namespace)}
        return dropped

    def demote_namespace(self, namespace: Any) -> int:
        """Push every fast-resident key of ``namespace`` down to the slow
        tier now (they stay readable); returns how many."""
        with self._lock:
            mine = [k for k in self._fast
                    if isinstance(k, tuple) and len(k) >= 2
                    and k[0] == namespace]
            to_drain = []
            for k in mine:
                d = self._evict_one_locked(k)
                if d is not None:
                    to_drain.append(d)
        self._write_behind(to_drain)
        return len(mine)

    def _evict_rank(self, key: Any):
        """Victim order, largest first: keys of no plan (oldest first)
        above plan keys, plan keys by reverse-use distance."""
        d = self._distance.get(key)
        if d is None:
            return (1, -self._seq.get(key, 0))
        return (0, d)

    def _evict_one_locked(self, victim: Any) -> Optional[Any]:
        """Move one fast resident to the write-behind map.  Returns the key
        if this thread must start its drain loop, else None."""
        tree = self._fast.pop(victim)
        nb = self._sizes.pop(victim)
        self.fast_live_bytes -= nb
        self._account_fast_drop_locked(victim, nb)
        self._seq.pop(victim, None)
        if victim in self._clean:     # slow copy already valid: drop
            self._clean.discard(victim)
            return None
        self._writing[victim] = tree
        if victim not in self._wb_active:
            self._wb_active.add(victim)
            return victim
        return None

    def _pick_victims_locked(self) -> list:
        """Evict residents, coldest first, until the budget, every tenant's
        quota and every namespace's cap hold (a tenant or namespace spills
        only its own keys).  Returns the keys whose drain loop this thread
        must run."""
        to_drain = []
        while self.fast_live_bytes > self.capacity_bytes and self._fast:
            victim = max(self._fast, key=self._evict_rank)
            d = self._evict_one_locked(victim)
            if d is not None:
                to_drain.append(d)
        for tenant, quota in self._quota.items():
            while self.tenant_fast_bytes.get(tenant, 0) > quota:
                mine = [k for k in self._fast
                        if self._owner_locked(k)[1] == tenant]
                if not mine:
                    break
                victim = max(mine, key=self._evict_rank)
                d = self._evict_one_locked(victim)
                if d is not None:
                    to_drain.append(d)
        for ns, cap in self._ns_cap.items():
            while self.ns_fast_bytes.get(ns, 0) > cap:
                mine = [k for k in self._fast
                        if self._owner_locked(k)[0] == ns]
                if not mine:
                    break
                victim = max(mine, key=self._evict_rank)
                d = self._evict_one_locked(victim)
                if d is not None:
                    to_drain.append(d)
        return to_drain

    def _write_behind(self, keys: list) -> None:
        """Drain each key's pending payload(s) to the slow tier.  One
        drainer per key (``_wb_active``): a re-eviction while a writeback
        is in flight replaces the pending payload, and this loop writes it
        afterwards, so a stale payload never lands on top of a newer one."""
        for key in keys:
            while True:
                with self._lock:
                    tree = self._writing.get(key)   # peek: stays readable
                    deleted = False
                    if tree is None:
                        deleted = key in self._wb_deleted
                        self._wb_deleted.discard(key)
                        if not deleted:         # drained: retire this drainer
                            self._wb_active.discard(key)
                            self._note_total_peak_locked()
                            break
                if tree is None:
                    # deleted while its writeback was in flight: remove the
                    # slow copy while still the key's drainer, so a
                    # re-store's writeback queues behind this delete
                    self.slow.delete(key)
                    continue
                self.slow.put(key, tree)
                with self._lock:
                    self.evictions += 1
                    if self._writing.get(key) is tree:   # not replaced/deleted
                        self._writing.pop(key)

    def _note_total_peak_locked(self) -> None:
        # fast lock -> slow lock is safe: the slow tier never calls back
        total = (self.fast_live_bytes
                 + sum(tree_bytes(t) for t in self._writing.values())
                 + self.slow.live_bytes)
        self._peak_total = max(self._peak_total, total)

    # -- backend protocol -----------------------------------------------------
    def put(self, key: Any, tree: Any) -> None:
        host = _freeze(tree)
        nb = tree_bytes(host)
        self._throttle(nb)
        with self._lock:
            ns, tenant = self._owner_locked(key)
            quota = self._quota.get(tenant) if tenant is not None else None
            ns_cap = self._ns_cap.get(ns) if ns is not None else None
        if nb > self.capacity_bytes or (quota is not None and nb > quota) \
                or (ns_cap is not None and nb > ns_cap):
            # one state alone overflows the budget (global, its tenant's
            # quota or its namespace's cap): bypass the fast tier
            with self._lock:
                self.bytes_written += nb
                self._drop_fast_locked(key)
                self._wb_deleted.discard(key)   # re-store revokes a tombstone
                if key in self._wb_active:
                    # an older writeback of this key is in flight: queue the
                    # new value behind it (per-key order)
                    self._writing[key] = host
                    self._note_total_peak_locked()
                    return
            self.slow.put(key, host)
            with self._lock:
                self._note_total_peak_locked()
            return
        with self._lock:
            self.bytes_written += nb
            self._drop_fast_locked(key)
            self._wb_deleted.discard(key)   # re-store revokes the tombstone
            self._fast[key] = host
            self._sizes[key] = nb
            self.fast_live_bytes += nb
            self._account_fast_add_locked(key, nb)
            self._seq[key] = self._next_seq
            self._next_seq += 1
            to_drain = self._pick_victims_locked()
            self._note_fast_peaks_locked()
            self._note_total_peak_locked()
        self._write_behind(to_drain)

    def _drop_fast_locked(self, key: Any) -> None:
        """Remove any fast-resident copy of ``key`` (re-store/overwrite)."""
        if key in self._fast:
            self._fast.pop(key)
            nb = self._sizes.pop(key)
            self.fast_live_bytes -= nb
            self._account_fast_drop_locked(key, nb)
            self._seq.pop(key, None)
        self._clean.discard(key)

    def _fast_read(self, key: Any) -> Any:
        """The fast-tier (or pending-writeback) copy of ``key``, counted as
        a fast hit, or None."""
        with self._lock:
            host = self._fast.get(key)
            if host is None:
                host = self._writing.get(key)
            if host is not None:
                nb = tree_bytes(host)
                self.fast_hits += 1
                self.bytes_read += nb
        if host is not None:
            self._throttle(nb)
        return host

    def get(self, key: Any) -> Any:
        host = self._fast_read(key)
        if host is not None:
            return host
        # slow-tier hit: fetch outside the lock, then promote (a disk or
        # compressed slow tier returns fresh arrays: freezing them in place
        # costs no copy)
        host = _freeze_in_place(self.slow.get(key))
        nb = tree_bytes(host)
        with self._lock:
            self.slow_hits += 1
            self.bytes_read += nb
            to_drain = []
            ns, tenant = self._owner_locked(key)
            quota = self._quota.get(tenant) if tenant is not None else None
            ns_cap = self._ns_cap.get(ns) if ns is not None else None
            if nb <= self.capacity_bytes and \
                    (quota is None or nb <= quota) and \
                    (ns_cap is None or nb <= ns_cap) and \
                    key not in self._fast:
                self.promotions += 1
                self._fast[key] = host
                self._sizes[key] = nb
                self.fast_live_bytes += nb
                self._account_fast_add_locked(key, nb)
                self._seq[key] = self._next_seq
                self._next_seq += 1
                self._clean.add(key)   # slow copy stays valid
                to_drain = self._pick_victims_locked()
                self._note_fast_peaks_locked()
            self._note_total_peak_locked()
        self._write_behind(to_drain)
        return host

    def peek(self, key: Any) -> Any:
        """Read ``key`` without promotion: a slow-tier hit is returned and
        never enters the fast tier, so ``peek`` evicts nothing.  Hit and
        byte counters are kept as for :meth:`get`."""
        host = self._fast_read(key)
        if host is not None:
            return host
        host = _freeze_in_place(self.slow.get(key))
        with self._lock:
            self.slow_hits += 1
            self.bytes_read += tree_bytes(host)
        return host

    def delete(self, key: Any) -> None:
        with self._lock:
            self._drop_fast_locked(key)
            self._writing.pop(key, None)    # cancel any pending writeback
            if key in self._wb_active:
                # a writeback is in flight: tombstone the key so its
                # drainer removes the slow copy once it lands
                self._wb_deleted.add(key)
            self._distance.pop(key, None)
        self.slow.delete(key)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            if key in self._fast or key in self._writing:
                return True
        return key in self.slow

    def keys(self) -> Iterable[Any]:
        with self._lock:
            fast = set(self._fast) | set(self._writing)
        return list(fast | set(self.slow.keys()))

    # -- accounting (live/peak span both tiers) -------------------------------
    @property
    def live_bytes(self) -> int:
        with self._lock:
            writing = sum(tree_bytes(t) for t in self._writing.values())
            fast = self.fast_live_bytes
        return fast + writing + self.slow.live_bytes

    @property
    def peak_bytes(self) -> int:
        """High-water mark of both tiers together (clean fast copies
        duplicate slow bytes, so an upper bound); the budgeted quantity
        is ``fast_peak_bytes``."""
        with self._lock:
            return max(self._peak_total, self.fast_peak_bytes,
                       self.slow.peak_bytes)


class _NamespacedPlan:
    """An offload plan with every key it names rewritten to ``(namespace,
    key)``.  Which verbs exist mirrors the wrapped plan (a missing one
    raises ``AttributeError``): :meth:`TieredStorage.set_plan` and
    :meth:`TieredStorage.plan_prefetch_distance` duck-type on them."""

    def __init__(self, plan: Any, namespace: Any):
        self._plan = plan
        self._ns = namespace

    def _t(self, key: Any):
        return (self._ns, key)

    @property
    def distances(self):
        f = getattr(self._plan, "distances", None)
        if f is None:
            raise AttributeError("distances")
        return lambda: {self._t(k): v for k, v in dict(f()).items()}

    @property
    def reverse_access_order(self):
        f = getattr(self._plan, "reverse_access_order", None)
        if f is None:
            raise AttributeError("reverse_access_order")
        return lambda: [self._t(k) for k in f()]

    @property
    def boundaries(self):
        f = getattr(self._plan, "boundaries", None)
        if f is None:
            raise AttributeError("boundaries")
        return lambda: [self._t(k) for k in f()]

    def __getattr__(self, name: str):
        return getattr(self.__dict__["_plan"], name)


class NamespacedStorage:
    """A shared backend seen through a key prefix: every key becomes
    ``(namespace, key)`` on the inner store, so several runs (whose
    boundary keys are the same segment begins) share one
    :class:`TieredStorage` and its budget, the namespace being the unit
    its quotas charge (:meth:`TieredStorage.register_namespace`).

    Every key-taking verb translates explicitly; ``set_plan`` merges into
    the shared Belady order (:meth:`TieredStorage.update_plan`) when the
    inner store has it.  :meth:`close` does nothing: disposing of one run
    must never close the tier its neighbours use.
    """

    def __init__(self, inner: Any, namespace: Any):
        self.inner = inner
        self.namespace = namespace

    def _k(self, key: Any):
        return (self.namespace, key)

    # -- backend protocol -----------------------------------------------------
    def put(self, key: Any, tree: Any) -> None:
        self.inner.put(self._k(key), tree)

    def get(self, key: Any) -> Any:
        return self.inner.get(self._k(key))

    def peek(self, key: Any) -> Any:
        f = getattr(self.inner, "peek", None)
        if f is None:
            return self.inner.get(self._k(key))
        return f(self._k(key))

    def delete(self, key: Any) -> None:
        self.inner.delete(self._k(key))

    def __contains__(self, key: Any) -> bool:
        return self._k(key) in self.inner

    def keys(self) -> Iterable[Any]:
        return [k[1] for k in self.inner.keys()
                if isinstance(k, tuple) and len(k) == 2
                and k[0] == self.namespace]

    # -- plan awareness -------------------------------------------------------
    def set_plan(self, plan: Any) -> None:
        wrapped = _NamespacedPlan(plan, self.namespace)
        update = getattr(self.inner, "update_plan", None)
        if update is not None:
            update(self.namespace, wrapped.distances()
                   if hasattr(wrapped, "distances")
                   else {k: d for d, k in
                         enumerate(wrapped.reverse_access_order())})
            return
        self.inner.set_plan(wrapped)

    def plan_prefetch_distance(self, plan: Any) -> int:
        f = getattr(self.inner, "plan_prefetch_distance", None)
        if f is None:
            return 1
        return f(_NamespacedPlan(plan, self.namespace))

    def drop(self) -> int:
        """Release this namespace's keys from both tiers."""
        f = getattr(self.inner, "drop_namespace", None)
        if f is not None:
            return f(self.namespace)
        n = 0
        for k in list(self.keys()):
            self.delete(k)
            n += 1
        return n

    def demote(self) -> int:
        """Push this namespace's fast-resident keys to the slow tier."""
        f = getattr(self.inner, "demote_namespace", None)
        if f is not None:
            return f(self.namespace)
        return 0

    def close(self) -> None:
        """No-op: the shared inner store outlives any one run."""

    # -- instrumentation: this namespace's slice of the shared tier -----------
    @property
    def fast_live_bytes(self) -> int:
        ns = getattr(self.inner, "ns_fast_bytes", None)
        if ns is not None and self.namespace in ns:
            return ns[self.namespace]
        return getattr(self.inner, "fast_live_bytes", 0)

    @property
    def fast_peak_bytes(self) -> int:
        ns = getattr(self.inner, "ns_fast_peak", None)
        if ns is not None and self.namespace in ns:
            return ns[self.namespace]
        return getattr(self.inner, "fast_peak_bytes", 0)

    def __getattr__(self, name: str):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)


class JournaledStorage:
    """Crash-consistent wrapper: write-ahead journal over any inner backend.

    Every ``put``/``delete`` appends a CRC'd record to
    ``<directory>/wal.log`` *before* touching the inner backend, whatever
    the inner backend does with the bytes (host RAM evaporates with the
    process; the journal does not).  Durability is **group-commit** at
    segment granularity: bulk records defer their fsync, and the next
    cursor/BEGIN/END append (or :meth:`commit`/:meth:`close`) is the
    commit barrier that lands them — one fsync per segment instead of one
    per record, with the same recovery guarantee: a durable cursor implies
    every store appended before it is durable (shared-fd fsync + WAL
    prefix semantics), so recovery can never claim a non-durable boundary.
    ``get`` serves from the inner backend when it has the key and
    re-hydrates from the journal otherwise (a fresh process after a
    crash), verifying the record CRC on that path.

    A STORE payload is the pickled tree of host numpy leaves (a bf16 leaf
    as :class:`Bits`), so an fp32 dict or tuple state decodes to plain
    numpy arrays; the inner backend still gets the tree as it was handed
    over (a fused advance's page-locked chunk entry stays the inner store's
    Level-2 copy, with no second copy).

    One gradient run is an *epoch*: ``begin_run(meta)`` marks the start
    (truncating the file when the previous epoch completed cleanly, so a
    healthy training loop's journal stays one run long), ``put_cursor``
    checkpoints the executor's :class:`~repro_torch.core.schedule.RunCursor`
    at segment granularity, ``end_run`` marks clean completion, and
    ``recover()`` returns a :class:`~repro_torch.core.journal.RecoveredRun`
    (surviving keys, last cursor, per-segment reverse artifacts).

    Damage semantics on open: a torn tail (crash mid-write) is silently
    truncated — that is the artifact journaling exists to absorb; a
    CRC-failing *complete* record is corruption and raises a typed
    :class:`~repro_torch.core.faults.ChecksumError` unless ``repair=True``
    (truncate back to the last good record and recover what precedes it).

    Unknown attributes delegate to the inner backend, so plan-aware verbs
    (``set_plan``, ``plan_prefetch_distance``) and instrumentation
    (``bytes_written``, ``fast_peak_bytes``, ...) pass straight through.
    """

    # The journal must log the *global* payload: a sharded inner store's
    # pre-split ``snapshot`` hook (ROADMAP queue 1, item 15) is disabled
    # through this wrapper, as in the JAX package — a class-level None stops
    # attribute lookup before __getattr__ can delegate it.
    snapshot = None

    def __init__(self, inner: Any, directory: str, *, repair: bool = False,
                 faults: Any = None):
        self.inner = inner
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._journal = _journal.JournalFile(
            os.path.join(directory, "wal.log"))
        self._faults = faults if faults is not None else _faults.active()
        self._lock = threading.Lock()
        self._index: Dict[Any, int] = {}   # key -> journal record offset
        self._cursor: Any = None
        self._artifacts: Dict[Any, Any] = {}
        self._meta: Dict[str, Any] = {}
        self._torn = False
        self._ended = False
        self._load(repair=repair)

    # ------------------------------------------------------------------- open
    def _load(self, repair: bool) -> None:
        scan = self._journal.scan()
        if scan.damage is not None:
            if scan.damage.kind == "checksum" and not repair:
                raise ChecksumError(
                    f"journal {self._journal.path}: {scan.damage.detail} "
                    "(reopen with repair=True to truncate to the last good "
                    "record and recover what precedes it)")
            # torn tail (normal crash artifact) or explicit repair: discard
            # everything from the damaged record on — framing is lost there
            self._journal.truncate(scan.valid_end)
            self._torn = True
        for rec in _journal.iter_epoch(scan.records):
            if rec.op == _journal.OP_BEGIN:
                self._index.clear()
                self._cursor = None
                self._artifacts.clear()
                self._ended = False
                self._meta = pickle.loads(rec.payload) if rec.payload else {}
            elif rec.op == _journal.OP_STORE:
                self._index[rec.key] = rec.start
            elif rec.op == _journal.OP_DELETE:
                self._index.pop(rec.key, None)
            elif rec.op == _journal.OP_CURSOR:
                self._note_cursor(pickle.loads(rec.payload))
            elif rec.op == _journal.OP_END:
                self._ended = True

    def _note_cursor(self, cursor: Any) -> None:
        self._cursor = cursor
        payload = getattr(cursor, "payload", None)
        if isinstance(payload, dict) and payload.get("artifact") is not None:
            self._artifacts[payload.get("artifact_key")] = payload["artifact"]

    # -------------------------------------------------------------- run verbs
    def begin_run(self, meta: Optional[Dict[str, Any]] = None) -> None:
        """Open a new epoch.  When the previous epoch completed cleanly
        (END seen and nothing left stored) the file is truncated first, so
        repeated training steps do not grow the journal without bound."""
        with self._lock:
            if self._ended and not self._index:
                self._journal.truncate(0)
            self._journal.append(
                _journal.OP_BEGIN,
                payload=pickle.dumps(dict(meta or {}),
                                     protocol=pickle.HIGHEST_PROTOCOL))
            self._index.clear()
            self._cursor = None
            self._artifacts.clear()
            self._meta = dict(meta or {})
            self._ended = False

    def put_cursor(self, cursor: Any, *, sync: bool = True) -> None:
        """Durably checkpoint the executor's plan cursor (FIFO-ordered
        behind the boundary stores when routed through the engine's
        writer queue — a cursor can never claim a segment whose boundary
        is not yet durable).

        ``sync=False`` defers the commit barrier: the record is written
        in order but fsyncs with the *next* barrier (cursor coalescing —
        the engine passes it when a newer cursor is already queued, so a
        burst of cursors costs one sync).  Consistency is unaffected
        (recovery reads a file prefix, and file order is unchanged); only
        the crash window widens from one cursor to the in-flight burst.
        """
        payload = pickle.dumps(cursor, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._journal.append(_journal.OP_CURSOR, payload=payload,
                                 sync=True if sync else False)
            self._note_cursor(cursor)

    def end_run(self) -> None:
        with self._lock:
            self._journal.append(_journal.OP_END)
            self._ended = True
            if not self._index:
                # Compact: a completed epoch's bulk (boundary payloads,
                # per-segment adjoint cursors) is dead weight — rewrite it
                # as a tiny done-marker epoch so the next open scans
                # O(bytes of one cursor) instead of re-reading and
                # re-CRC-ing the whole previous sweep's Level-2 traffic.
                self._journal.truncate(0)
                # group commit inside the compaction too: the rewritten
                # epoch only matters as a whole, so its BEGIN/CURSOR defer
                # to the closing END barrier (one sync, not three)
                self._journal.append(
                    _journal.OP_BEGIN,
                    payload=pickle.dumps(dict(self._meta),
                                         protocol=pickle.HIGHEST_PROTOCOL),
                    sync=False)
                if self._cursor is not None:
                    self._journal.append(
                        _journal.OP_CURSOR,
                        payload=pickle.dumps(
                            self._cursor,
                            protocol=pickle.HIGHEST_PROTOCOL),
                        sync=False)
                self._journal.append(_journal.OP_END)

    def recover(self) -> RecoveredRun:
        """The last epoch's durable state (keys in store order, last
        cursor, reverse artifacts).  A cleanly-ended epoch still reports
        its cursor — callers treat ``phase == "done"`` as nothing-to-do."""
        with self._lock:
            return RecoveredRun(keys=tuple(self._index),
                                cursor=self._cursor,
                                artifacts=dict(self._artifacts),
                                meta=dict(self._meta),
                                torn=self._torn,
                                journal_bytes=self._journal.size)

    @property
    def cursor(self) -> Any:
        with self._lock:
            return self._cursor

    @property
    def journal_bytes(self) -> int:
        return self._journal.size

    @property
    def journal_path(self) -> str:
        return self._journal.path

    @property
    def fsync_count(self) -> int:
        """Commit barriers (``fdatasync`` calls) made so far."""
        return self._journal.fsync_count

    # -------------------------------------------------------- backend protocol
    def put(self, key: Any, tree: Any) -> None:
        # host numpy views (no copy): pickling copies the bytes
        host = pytree.tree_map(_leaf_numpy, tree)
        key_b = pickle.dumps(key, protocol=pickle.HIGHEST_PROTOCOL)
        payload = pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            # group commit: the store's fsync is deferred to the segment's
            # cursor barrier (put_cursor / begin_run / end_run / commit) —
            # one fsync per batch, same durability at segment granularity
            start, end = self._journal.append(_journal.OP_STORE, key_b,
                                              payload, sync=False)
            self._index[key] = start
        if self._faults is not None:
            # may tear/corrupt the record just written and/or kill the
            # writing thread (simulated crash mid-spill)
            self._faults.on_journal_store(self._journal, start, end)
        self.inner.put(key, tree)

    def get(self, key: Any) -> Any:
        if key in self.inner:
            return self.inner.get(key)
        # Re-hydrate from the journal (fresh process after a crash), then
        # serve through the inner backend: for a lossy inner (compressed)
        # the put/get round-trip reproduces exactly the decoded values the
        # fault-free run read back, so resumed reverse sweeps stay
        # bit-identical.  The record CRC is re-verified on the journal
        # read -> typed ChecksumError.
        self.inner.put(key, self._read_journal(key))
        return self.inner.get(key)

    def get_exact(self, key: Any) -> Any:
        """The raw journaled payload, bypassing any lossy inner codec.

        The executor's resume path loads its restart state through this:
        the crashed run advanced from the *exact* running state at the
        boundary (lossy encoding only ever applied to what the reverse
        sweep reads back), so a bit-identical forward replay must start
        from the raw journal record, not from a decode(encode(x))
        round-trip."""
        with self._lock:
            off = self._index.get(key)
        if off is not None:
            return self._read_journal(key)
        return self.inner.get(key)   # not journaled (shouldn't happen)

    def _read_journal(self, key: Any) -> Any:
        with self._lock:
            off = self._index.get(key)
        if off is None:
            raise KeyError(key)
        return _freeze_in_place(
            pickle.loads(self._journal.read_payload(off)))

    def delete(self, key: Any) -> None:
        key_b = pickle.dumps(key, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            # deferred like put: a retired boundary's delete only matters
            # once a later cursor (which fsyncs) has superseded it
            self._journal.append(_journal.OP_DELETE, key_b, sync=False)
            self._index.pop(key, None)
        self.inner.delete(key)

    def commit(self) -> None:
        """Explicit group-commit barrier: fsync any deferred STORE/DELETE
        records now (no-op when nothing is pending).  The run verbs
        (``put_cursor``/``begin_run``/``end_run``) are themselves barriers,
        so the executor never needs this — it exists for callers driving
        the backend directly."""
        self._journal.flush()

    def __contains__(self, key: Any) -> bool:
        if key in self.inner:
            return True
        with self._lock:
            return key in self._index

    def keys(self) -> Iterable[Any]:
        with self._lock:
            journal_keys = set(self._index)
        return list(journal_keys | set(self.inner.keys()))

    def close(self) -> None:
        # land any deferred records before the fd goes away: close is a
        # commit barrier too
        try:
            self._journal.flush()
        finally:
            self._journal.close()

    def __getattr__(self, name: str):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Callable[..., Any]] = {}


def register_backend(name: str, factory: Callable[..., Any]) -> None:
    """Register a Level-2 backend factory under ``name`` (overwrites)."""
    _BACKENDS[name] = factory


def make_backend(kind: str, *, journal: Optional[str] = None,
                 journal_repair: bool = False,
                 shards: Optional[int] = None, **kwargs: Any) -> Any:
    """Build a Level-2 backend by name.

    Built-ins: ``"ram"`` (``bandwidth=`` optional throttle), ``"disk"``
    (``directory=`` required), ``"compressed"`` (int8 wrapper;
    ``directory=`` puts its inner store on disk), ``"tiered"``
    (``capacity_bytes=`` required fast-tier budget; ``directory=`` puts the
    slow tier on disk, ``compress=True`` int8-quantises spilled copies).

    ``journal=<directory>`` composes a :class:`JournaledStorage` over the
    backend: every store/delete is write-ahead-logged (CRC + fsync at each
    segment's commit barrier) so the run is crash-consistent and resumable.  The
    journal always records the *raw* boundary payloads (a lossy inner
    codec like ``"compressed"`` costs its ~4x saving in the WAL): the
    resume path restarts forward replay from the exact pre-crash state
    (:meth:`JournaledStorage.get_exact`), while re-hydrated reverse-sweep
    reads round-trip through the inner backend so they reproduce exactly
    the (possibly lossy-decoded) values the fault-free run read back.
    ``journal_repair=True`` truncates a CRC-damaged journal back to its
    last good record on open instead of raising
    :class:`~repro_torch.core.faults.ChecksumError`.  ``shards=`` raises
    ``NotImplementedError`` (ROADMAP queue 1, item 15).
    """
    try:
        factory = _BACKENDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown Level-2 backend {kind!r}; known: "
            f"{sorted(_BACKENDS)}") from None
    if shards is not None:
        raise NotImplementedError(
            "make_backend(shards=...) is not ported yet (ROADMAP queue 1, "
            "item 15)")
    backend = factory(**kwargs)
    if journal is None:
        return backend
    return JournaledStorage(backend, journal, repair=journal_repair)


register_backend("ram", lambda bandwidth=None: RAMStorage(bandwidth))
register_backend("disk", lambda directory: DiskStorage(directory))
register_backend(
    "compressed",
    lambda directory=None, min_bytes=256, inner=None: CompressedStorage(
        inner=inner, directory=directory, min_bytes=min_bytes))
register_backend(
    "tiered",
    lambda capacity_bytes, directory=None, slow=None, compress=False,
    bandwidth=None: TieredStorage(
        capacity_bytes, slow=slow, directory=directory, compress=compress,
        bandwidth=bandwidth))


_SIDE_STREAMS: Dict[Any, Any] = {}



def _side_stream(kind: str, device: Any):
    """The process's copy stream of ``kind`` on ``device``, shared by every
    engine: the caching allocator keeps freed blocks per stream, so uploads
    on one stream reuse the blocks of the previous call's instead of
    allocating anew on a fresh stream each call."""
    key = (kind, None if device is None else torch.device(device))
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[key]


class AsyncTransferEngine:
    """Async store/prefetch around a Level-2 backend.

    * One writer thread drains a store queue (FIFO, preserves the schedule's
      store order).  A store waits while ``MAX_PENDING_STORES`` earlier
      ones are not yet in the backend, so the caller runs at most that
      many segments ahead of the writer and the host buffers in flight
      stay few (a capacity-bounded store then holds at most its budget
      and these in page-locked memory).
    * One prefetch thread, started at the first prefetch, drains a queue of
      prefetches in the order they were issued; each result lands in a
      staging dict under the key's event, which ``wait_prefetch`` joins on,
      and an error is raised at the caller's next wait.
    * The parameter lane rides the same thread: ``prefetch_params_async``
      queues one job for a batch of blob keys (one segment's), each staged
      under its own event, and ``wait_param`` consumes them; the counters
      are ``num_param_prefetches`` (batches issued),
      ``param_fetch_stalls`` (waits that blocked, or demand reads) and
      ``param_bytes_moved``.  With ``prefetch_via_peek`` every read, the
      boundaries' too, goes through the backend's non-promoting ``peek``
      where it has one, so streamed reads cannot reorder a tiered store's
      fast tier.

    ``device`` (optional) is where prefetched states are wanted: with a
    device, ``wait_prefetch`` returns tensors there; without one it returns
    the backend's host arrays.  Stall times are instrumented; counters and
    staged-byte accounting are guarded by the engine lock.

    ``delete(key)`` invalidates any staged prefetch of ``key`` and detaches
    its in-flight prefetch job, so a delete + re-store + prefetch sequence
    always observes the re-stored value, never a stale staged one.

    ``cursor_async`` rides a journaled backend's plan cursor behind the
    queued stores (FIFO: a durable cursor implies durable boundaries).
    ``faults`` (default: :func:`repro_torch.core.faults.active`, read once
    here) is the fault injector whose hooks the writer loop and the fetches
    call.
    """

    MAX_PENDING_STORES = 2

    def __init__(self, backend, device: Any = None, faults: Any = None):
        self.backend = backend
        self.device = None if device is None else torch.device(device)
        # fault injection (tests): read once at construction; every hook
        # site below is a single `is not None` test, so the disabled path
        # costs nothing
        self.faults = faults if faults is not None else _faults.active()
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
        self._pending_cursors = 0   # queued cursors (for commit coalescing)
        self._pending_puts = 0      # stores not yet in the backend
        self._puts_done = threading.Condition()
        self._writer = threading.Thread(target=self._writer_loop, daemon=True)
        self._writer.start()
        self._prefetch_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._prefetcher: Optional[threading.Thread] = None
        self._fence = None   # the compute stream at the last wait (CUDA)
        # the parameter lane
        self._param_staged: Dict[Any, Any] = {}
        self._param_events: Dict[Any, threading.Event] = {}
        self.num_param_prefetches = 0   # prefetch batches issued
        self.param_fetch_stalls = 0     # wait_param calls that had to wait
        self.param_bytes_moved = 0      # bytes fetched through the lane
        self.param_stall_s = 0.0
        # read via a tiered store's non-promoting peek (parameter streaming)
        self.prefetch_via_peek = False

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
                    # the thread keeps no reference to a stored payload
                    # while it waits for the next item (a pooled
                    # page-locked slot returns when Level 2 lets go of it)
                    item = None
                    try:
                        if self.faults is not None:
                            self.faults.on_writer_store(key)
                        self._put(key, payload)
                    finally:
                        payload = None
                        with self._puts_done:
                            self._pending_puts -= 1
                            self._puts_done.notify_all()
                elif kind == "cursor":
                    self._put_cursor(item[1])
                else:  # "delete"
                    self.backend.delete(item[1])
                item = None
            except WriterKilled:
                # simulated abrupt writer death: leave the item un-done so
                # joins observe exactly what a killed thread leaves behind
                return
            except Exception as e:  # surfaced on wait_stores
                self._errors.append(e)
                self._store_q.task_done()
            else:
                self._store_q.task_done()

    def _snapshot(self, tree: Any, fenced: bool = False) -> Any:
        """Detach ``tree`` from Level 1 on the caller's thread without
        blocking it: CUDA leaves are copied into page-locked buffers on the
        copy stream (fenced by an event), host leaves are deep-copied.
        ``fenced`` copies on the current stream instead, so work queued
        after it (an in-place add into the same tensors) cannot overwrite
        a leaf before it has been read."""
        leaves, spec = pytree.tree_flatten(tree)
        if not any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
            return _to_host(tree)
        if fenced:
            stream = torch.cuda.current_stream()
        else:
            if self._copy_stream is None:
                self._copy_stream = _side_stream("d2h", None)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream())
        host = []
        with torch.cuda.stream(stream):
            for x in leaves:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                if not fenced:
                    x.record_stream(stream)
                host.append(h)
            ready = torch.cuda.Event()
            ready.record(stream)
        return HostTree(pytree.tree_unflatten(host, spec), ready)

    def _payload(self, tree: Any) -> Any:
        """The caller's half of a store: ``tree`` detached from Level 1
        (:meth:`_snapshot`), or a :class:`HostTree` handed over as it is,
        its buffers frozen into the Level-2 copy at once (so a buffer that
        does not own its storage is refused on the caller's thread)."""
        if not isinstance(tree, HostTree):
            tree = self._snapshot(tree)
            if not isinstance(tree, HostTree):
                return tree   # host leaves, already deep-copied
        return HostTree(_frozen_views(tree.tree), tree.ready)

    def _put(self, key: Any, payload: Any) -> None:
        """The writer's half of a store: wait for the payload's event, then
        hand it to the backend."""
        if isinstance(payload, HostTree):
            payload = payload.wait()
        self.backend.put(key, payload)

    def store_async(self, key: Any, tree: Any) -> None:
        """Enqueue a Level-2 store of ``tree`` (a :class:`HostTree` is
        handed over as it is: its buffers become the Level-2 copy)."""
        payload = self._payload(tree)
        with self._puts_done:
            if self._pending_puts >= self.MAX_PENDING_STORES:
                t0 = time.perf_counter()
                # a dead writer leaves its store pending: the join that
                # follows reports it
                while self._pending_puts >= self.MAX_PENDING_STORES \
                        and self._writer.is_alive():
                    self._puts_done.wait(timeout=0.05)
                self.store_stall_s += time.perf_counter() - t0
            self._pending_puts += 1
        self._store_q.put(("put", key, payload))
        with self._lock:
            self.num_stores += 1

    def store_now(self, key: Any, tree: Any, backend: Any = None) -> None:
        """A store made on the caller's thread through the same two halves
        as :meth:`store_async` (the autotuner's ``T_T`` probe), into
        ``backend`` (default: the engine's; the tiered probe passes the
        slow tier).  Not counted in ``num_stores``."""
        payload = self._payload(tree)
        if backend is None:
            self._put(key, payload)
        else:
            backend.put(key, payload.wait()
                        if isinstance(payload, HostTree) else payload)

    def cursor_async(self, cursor: Any) -> None:
        """Enqueue a journal cursor checkpoint behind the pending stores.

        FIFO ordering through the writer queue is the consistency
        argument: a durable cursor implies every store enqueued before it
        is durable too, so recovery can trust the cursor's plan position.
        Requires a journaled backend (one with ``put_cursor``).

        The payload's trees (``adjoint``, ``artifact``) are snapshotted
        here, on the caller's thread, as a store's are: the reverse sweep
        adds into its gradient accumulator in place, so a tree read later
        on the writer thread could already hold the next segment's
        contribution.  Scalar fields (``artifact_key``) stay as they are.
        """
        payload = getattr(cursor, "payload", None)
        if payload:
            payload = dict(payload)
            for f in ("adjoint", "artifact"):
                if payload.get(f) is not None:
                    payload[f] = self._snapshot(payload[f], fenced=True)
            cursor = dataclasses.replace(cursor, payload=payload)
        with self._lock:
            self._pending_cursors += 1
        self._store_q.put(("cursor", cursor))

    def _put_cursor(self, cur: Any) -> None:
        """The writer's half of :meth:`cursor_async`: wait for the
        payload's snapshots, turn them into host numpy trees (a bf16 leaf
        as :class:`Bits`), and checkpoint the cursor."""
        with self._lock:
            self._pending_cursors -= 1
            # coalesce: a newer cursor is already queued, so this one's
            # commit barrier can ride with it (one sync per burst; file
            # order — hence recovery consistency — is unchanged)
            last = self._pending_cursors == 0
        payload = getattr(cur, "payload", None)
        if payload:
            payload = dict(payload)
            for f in ("adjoint", "artifact"):
                v = payload.get(f)
                if isinstance(v, HostTree):
                    payload[f] = pytree.tree_map(_leaf_numpy, v.wait())
            cur = dataclasses.replace(cur, payload=payload)
        self.backend.put_cursor(cur, sync=last)

    def delete_async(self, key: Any) -> None:
        """Like :meth:`delete`, but the backend delete rides the writer
        queue (FIFO behind any cursor checkpoint that still references the
        key's segment).  Staged/in-flight prefetches of the key are still
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
    def _fetch(self, key: Any, hook: bool = True,
               peek: Optional[bool] = None) -> Any:
        """Read ``key`` from the backend (through its non-promoting
        ``peek`` where it has one, when ``peek`` — by default
        ``prefetch_via_peek`` — is set) and, with a device, place it there.
        Every
        engine-level fetch funnels through here: the fault-injection hook
        (unless ``hook`` is False: a prefetch calls it when issued), and a
        bare ``KeyError`` from a key whose store is stuck behind a dead
        writer thread is re-raised as a :class:`WriterCrashError`."""
        if hook and self.faults is not None:
            self.faults.on_get(key)   # may raise InjectedFault
        read = self.backend.get
        if self.prefetch_via_peek if peek is None else peek:
            read = getattr(self.backend, "peek", None) or read
        try:
            val = read(key)
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
        if self.device.type != "cuda":
            host = pytree.tree_map(_host_tensor, val)
            return pytree.tree_map(lambda t: t.to(self.device), host)
        # staged through page-locked memory on this thread, so the upload
        # below is asynchronous whatever tier the value came from
        host = pytree.tree_map(lambda a: _host_tensor(a, pin=True), val)
        if self._h2d_stream is None:
            self._h2d_stream = _side_stream("h2d", self.device)
        with torch.cuda.stream(self._h2d_stream):
            out = pytree.tree_map(
                lambda t: t.to(self.device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(self._h2d_stream)
        done.synchronize()   # this (prefetch) thread waits, never compute
        return out

    def _publish(self, key: Any, ev: threading.Event, val: Any = None,
                 error: Optional[Exception] = None) -> None:
        """Stage a prefetch's value (or record its error) and set its
        event.  Only while ``ev`` is still the registered one for the key:
        a delete (or delete + re-store + new prefetch) in the meantime
        detaches the job, so its value can never be observed stale."""
        try:
            with self._lock:
                if self._prefetch_events.get(key) is ev:
                    if error is not None:
                        self._errors.append(error)
                    else:
                        self._prefetched[key] = val
                        self.staged_bytes += tree_bytes(val)
                        self.staged_peak_bytes = max(self.staged_peak_bytes,
                                                     self.staged_bytes)
        finally:
            ev.set()

    def _prefetch_loop(self) -> None:
        while True:
            item = self._prefetch_q.get()
            if item is None:
                return
            if item[0] == "params":
                todo, item = item[1], None
                self._fetch_params(todo)
                continue
            _, key, ev = item
            item = None
            try:
                # upload only once the compute stream has run what it had
                # queued at the last wait (the segment before the one now
                # reversed): the uploads' freed blocks are then back in the
                # caching allocator whatever the host's lead, and a warm
                # call allocates none
                fence = self._fence
                if fence is not None:
                    fence.synchronize()
                val = self._fetch(key, hook=False)
            except Exception as e:
                self._publish(key, ev, error=e)
            else:
                self._publish(key, ev, val)
            # no reference to the value while the thread waits (a pooled
            # page-locked slot returns when Level 2 lets go of it)
            val = None

    def prefetch_async(self, key: Any) -> None:
        """Queue a fetch of ``key`` for the prefetch thread.  The fault hook
        runs here, on the caller's thread: an injected fetch failure is
        recorded before the caller's next wait, which raises it."""
        with self._lock:
            if key in self._prefetched or key in self._prefetch_events:
                return
            ev = threading.Event()
            self._prefetch_events[key] = ev
            self.num_prefetches += 1
        if self.faults is not None:
            try:
                self.faults.on_get(key)
            except Exception as e:
                self._publish(key, ev, error=e)
                return
        self._enqueue(("state", key, ev))

    def _enqueue(self, job) -> None:
        if self._prefetcher is None:
            self._prefetcher = threading.Thread(target=self._prefetch_loop,
                                                daemon=True)
            self._prefetcher.start()
        self._prefetch_q.put(job)

    def _adopt(self, val: Any) -> Any:
        """Hand prefetched CUDA tensors to the compute stream (their memory
        was allocated on the upload stream), and record the fence the
        prefetch thread waits for before its next upload."""
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream()
            for t in pytree.tree_leaves(val):
                t.record_stream(stream)
            fence = torch.cuda.Event()
            fence.record(stream)
            self._fence = fence
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

    # -- parameter lane -------------------------------------------------------
    def _fetch_params(self, todo) -> None:
        """The prefetch thread's half of :meth:`prefetch_params_async`: each
        blob of the batch in order, staged under its own event (published
        only while that event is still the key's).  The batch waits once,
        before its first upload, for the compute stream to pass the caller's
        last wait (as a boundary prefetch does): the blobs of at most the
        segments in flight hold device memory, and the uploads within a
        batch run back to back."""
        fence = self._fence
        if fence is not None:
            fence.synchronize()
        for k, ev in todo:
            try:
                val = self._fetch(k, hook=False, peek=True)
            except Exception as e:
                with self._lock:
                    if self._param_events.get(k) is ev:
                        self._errors.append(e)
            else:
                with self._lock:
                    if self._param_events.get(k) is ev:
                        self._param_staged[k] = val
                        self.param_bytes_moved += tree_bytes(val)
            finally:
                ev.set()
            val = None

    def prefetch_params_async(self, keys: Iterable[Any]) -> None:
        """Fetch a batch of parameter blobs (one segment's streamed
        weights) behind the current segment's compute: one job on the
        prefetch thread reads them in order, staging each under its own
        key, so a ``wait_param`` for the first can return while later ones
        are still in flight.  Keys already staged or in flight are skipped;
        the fault hook runs here for each key, as a prefetch's does."""
        with self._lock:
            todo = []
            for k in keys:
                if k in self._param_staged or k in self._param_events:
                    continue
                ev = threading.Event()
                self._param_events[k] = ev
                todo.append((k, ev))
            if todo:
                self.num_param_prefetches += 1
        if not todo:
            return
        if self.faults is not None:
            for k, ev in todo:
                try:
                    self.faults.on_get(k)
                except Exception as e:
                    with self._lock:
                        if self._param_events.get(k) is ev:
                            self._errors.append(e)
                    ev.set()
            todo = [(k, ev) for k, ev in todo if not ev.is_set()]
        self._enqueue(("params", todo))

    def wait_param(self, key: Any) -> Any:
        """Consume one staged parameter blob (on the engine's device).  A
        blob still in flight is waited for; one never prefetched (or
        invalidated by a delete) is read on demand — both count in
        ``param_fetch_stalls``."""
        _MISSING = object()
        with self._lock:
            ev = self._param_events.get(key)
            val = self._param_staged.pop(key, _MISSING)
            if val is not _MISSING:
                self._param_events.pop(key, None)
        if val is not _MISSING:
            return self._adopt(val)
        if ev is not None:
            stalled = not ev.is_set()
            t0 = time.perf_counter()
            ev.wait()
            self.param_stall_s += time.perf_counter() - t0
            self._raise_pending()
            with self._lock:
                if stalled:
                    self.param_fetch_stalls += 1
                if self._param_events.get(key) is ev:
                    self._param_events.pop(key)
                val = self._param_staged.pop(key, _MISSING)
            if val is not _MISSING:
                return self._adopt(val)
        else:
            # never prefetched: a demand read, a full stall
            self._raise_pending()
            with self._lock:
                self.param_fetch_stalls += 1
        # never prefetched, or invalidated between its event and this wait
        t0 = time.perf_counter()
        val = self._fetch(key, peek=True)
        self.param_stall_s += time.perf_counter() - t0
        with self._lock:
            self.param_bytes_moved += tree_bytes(val)
        self._raise_pending()
        return self._adopt(val)

    def _invalidate(self, key: Any) -> None:
        with self._lock:
            self._prefetch_events.pop(key, None)   # detaches in-flight jobs
            dropped = self._prefetched.pop(key, None)
            if dropped is not None:
                self.staged_bytes -= tree_bytes(dropped)
            self._param_events.pop(key, None)
            self._param_staged.pop(key, None)

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
            events = list(self._prefetch_events.values()) + \
                list(self._param_events.values())
        for ev in events:
            ev.wait(timeout=2.0)
        if self._prefetcher is not None:
            self._prefetch_q.put(None)
            self._prefetcher.join(timeout=2.0)
        with self._lock:
            self._prefetched.clear()
            self._prefetch_events.clear()
            self._param_staged.clear()
            self._param_events.clear()
            self.staged_bytes = 0
        self._raise_pending()
