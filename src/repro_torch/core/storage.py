# Port of repro/core/storage.py: tree_bytes, _freeze, _freeze_in_place,
# RAMStorage, DiskStorage, CompressedStorage, TieredStorage,
# NamespacedStorage, register_backend/make_backend and AsyncTransferEngine.
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
  (:class:`NamespacedStorage`).

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
  bytes it counts;
* a prefetch reads the host copy and moves it host-to-device on a side
  stream from the prefetch thread (a leaf that is not a view of a
  page-locked Level-2 buffer — a disk read, a decoded or promoted state —
  is first copied into page-locked memory there); the thread waits for
  that copy before it publishes the value, so ``wait_prefetch`` returns
  tensors that are ready to use.

``delete`` invalidates any staged prefetch of the key, and staged-prefetch
bytes are counted (``staged_bytes`` / ``staged_peak_bytes``).  The
journaled and sharded backends, the parameter lane and the fault hooks come
later (ROADMAP queue 1, items 8, 12 and 15).
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed.compression import dequantize_np, quantize_np


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
        return arr

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


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Callable[..., Any]] = {}


def register_backend(name: str, factory: Callable[..., Any]) -> None:
    """Register a Level-2 backend factory under ``name`` (overwrites)."""
    _BACKENDS[name] = factory


def make_backend(kind: str, *, journal: Optional[str] = None,
                 shards: Optional[int] = None, **kwargs: Any) -> Any:
    """Build a Level-2 backend by name.

    Built-ins: ``"ram"`` (``bandwidth=`` optional throttle), ``"disk"``
    (``directory=`` required), ``"compressed"`` (int8 wrapper;
    ``directory=`` puts its inner store on disk), ``"tiered"``
    (``capacity_bytes=`` required fast-tier budget; ``directory=`` puts the
    slow tier on disk, ``compress=True`` int8-quantises spilled copies).
    ``journal=`` and ``shards=`` raise ``NotImplementedError``.
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
    if journal is not None:
        raise NotImplementedError(
            "make_backend(journal=...) is not ported yet (ROADMAP queue 1, "
            "item 8)")
    return factory(**kwargs)


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
                    self._put(item[1], item[2])
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
        if self.device.type != "cuda":
            host = pytree.tree_map(_host_tensor, val)
            return pytree.tree_map(lambda t: t.to(self.device), host)
        # staged through page-locked memory on this thread, so the upload
        # below is asynchronous whatever tier the value came from
        host = pytree.tree_map(lambda a: _host_tensor(a, pin=True), val)
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
