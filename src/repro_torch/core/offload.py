# Port of repro/core/offload.py: the residual names, host_offload_supported
# and the counterpart of segment_policy (the scan engine's boundary store).
"""Where the scan engine keeps a segment's entry carry.

In the JAX package a ``jax.checkpoint`` policy names the residuals of a
rematerialised segment that live in host memory, and XLA lowers them to
asynchronous device-to-host copies.  A torch autograd function has no
policy: the segment function of :mod:`repro_torch.core.multistage_scan`
asks a :class:`SegmentPolicy` to keep its entry carry and to hand it back
to its backward pass.

* ``BOUNDARY`` (offloaded): each leaf is copied into a slot of a
  :class:`~repro_torch.core.storage.PinnedSlotPool` — page-locked host
  memory on the card (Level 2), copied device to host on a copy stream
  behind a CUDA event, so the compute stream never waits for it.  The
  backward pass of the segment after it uploads it one segment ahead, on
  another copy stream, fenced by events.  On the CPU the same slots are
  ordinary host memory and the copies are host to host, so a CPU run
  offloads (and counts) one boundary a segment as the card does.
* ``INNER_BOUNDARY`` (kept): the carry tensors themselves stay where they
  are (Level 1), as the reference's inner chunks do.

The remat policies of the reference (``make_policy``, ``offload_policy``,
...) name XLA residuals a torch program does not have, and the mesh
helpers (``host_sharding``, ``to_host``, ``local_shards``,
``assemble_shards``) wait for sharded offloading (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.storage import PinnedSlotPool, _side_stream

# Residual-name vocabulary (shared with core/multistage_scan).
BOUNDARY = "ms_boundary"          # segment-boundary carry -> Level 2
INNER_BOUNDARY = "ms_inner"       # nested sub-segment boundary -> Level 1
LAYER_INPUT = "layer_input"       # transformer layer input activation
ATTN_OUT = "attn_out"
MLP_OUT = "mlp_out"
QKV = "qkv_proj"
FFN_PRE = "ffn_pre"

DEVICE = "device"
HOST = "pinned_host"


def host_offload_supported(device: Any = None) -> bool:
    """Whether boundaries offloaded from ``device`` (default: the card, if
    there is one) cross to page-locked host memory: true on a CUDA device.
    On the CPU an offloaded boundary is a host-to-host copy."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@dataclasses.dataclass
class ScanRecord:
    """What one scan-engine call moved (the reference's scan engine keeps
    no ``ExecutionStats``; :func:`last_record` is its counterpart).  The
    backward counters fill in as the backward pass runs."""

    segments: int = 0
    boundaries_offloaded: int = 0   # entry carries copied to Level 2
    pinned_boundaries: int = 0      # ... of them into page-locked memory
    d2h_bytes: int = 0              # bytes copied to Level 2
    h2d_bytes: int = 0              # bytes copied back
    prefetches: int = 0             # uploads issued a segment ahead
    demand_loads: int = 0           # uploads issued by the segment itself
    blocked_waits: int = 0          # uploads not finished when consumed


_LAST: Dict[str, Optional[ScanRecord]] = {"record": None}


def last_record() -> Optional[ScanRecord]:
    """The :class:`ScanRecord` of the most recent scan-engine call."""
    return _LAST["record"]


def publish(record: ScanRecord) -> None:
    _LAST["record"] = record


_POOLS: Dict[Tuple, PinnedSlotPool] = {}
_POOLS_LOCK = threading.Lock()
# numpy has no bf16: its slots are int16 tensors viewed as bf16
_SLOT_DTYPE = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _slot(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A free host slot shaped like ``t`` (page-locked when ``pin``), from a
    pool shared by every scan call; it returns to the pool when nothing
    holds it any more."""
    dtype = _SLOT_DTYPE.get(t.dtype, t.dtype)
    key = (tuple(t.shape), dtype, pin)
    with _POOLS_LOCK:
        pool = _POOLS.get(key)
        if pool is None:
            pool = _POOLS[key] = PinnedSlotPool([t.shape], dtype, pin=pin)
    _, (h,) = pool.take()
    return h.view(t.dtype) if dtype != t.dtype else h


def clear_pools() -> None:
    """Drop the slot pools (their page-locked memory returns once no
    boundary holds a slot)."""
    with _POOLS_LOCK:
        _POOLS.clear()


def _nbytes(leaves: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


class Boundary:
    """One segment's entry carry as the policy keeps it: host slots and the
    event after which they hold the carry (offloaded), or the carry
    tensors themselves (kept); ``upload`` is the copy back once issued."""

    __slots__ = ("leaves", "ready", "device", "upload")

    def __init__(self, leaves, ready=None, device=None):
        self.leaves = leaves
        self.ready = ready
        self.device = device
        self.upload = None


class SegmentPolicy:
    """The counterpart of the reference's ``segment_policy(offload,
    boundary_name)``: ``save`` keeps a segment's entry carry, ``prefetch``
    starts bringing it back, ``load`` returns it as tensors on the
    device it came from.  ``offload=False`` keeps the carry in Level 1
    (plain segmented recompute, the reference's ``save_policy``; the
    reference's inner boundaries, ``INNER_BOUNDARY``)."""

    def __init__(self, offload: bool):
        self.offload = bool(offload)

    def save(self, leaves: List[torch.Tensor],
             record: ScanRecord) -> Boundary:
        if not self.offload:
            return Boundary(list(leaves))
        device = leaves[0].device
        record.boundaries_offloaded += 1
        record.d2h_bytes += _nbytes(leaves)
        if device.type != "cuda":
            hosts = [_slot(t, pin=False) for t in leaves]
            for h, t in zip(hosts, leaves):
                h.copy_(t)
            return Boundary(hosts, device=device)
        hosts = [_slot(t, pin=True) for t in leaves]
        stream = _side_stream("d2h", device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for h, t in zip(hosts, leaves):
                h.copy_(t, non_blocking=True)
                # the carry may be freed by the caller before the copy runs
                t.record_stream(stream)
            ready = torch.cuda.Event()
            ready.record(stream)
        record.pinned_boundaries += int(all(h.is_pinned() for h in hosts))
        return Boundary(hosts, ready, device)

    def prefetch(self, b: Boundary, record: ScanRecord,
                 ahead: bool = True) -> None:
        """Issue the copy back of ``b`` (``ahead``: for a later segment's
        backward pass; else the segment's own, at once)."""
        if not self.offload or b.upload is not None:
            return
        if ahead:
            record.prefetches += 1
        else:
            record.demand_loads += 1
        record.h2d_bytes += _nbytes(b.leaves)
        if b.device.type != "cuda":
            b.upload = ([h.clone() for h in b.leaves], None)
            b.leaves = None
            return
        stream = _side_stream("h2d", b.device)
        with torch.cuda.stream(stream):
            stream.wait_event(b.ready)
            dev = [h.to(b.device, non_blocking=True) for h in b.leaves]
            done = torch.cuda.Event()
            done.record(stream)
        b.upload = (dev, done)

    def load(self, b: Boundary, record: ScanRecord) -> List[torch.Tensor]:
        """The carry of ``b`` on its device, ready for the compute stream:
        the upload issued ahead (issued now if none was), which the compute
        stream waits for on the card; a wait on an upload that had not
        finished yet counts in ``record.blocked_waits``."""
        if not self.offload:
            leaves, b.leaves = b.leaves, None
            return leaves
        self.prefetch(b, record, ahead=False)
        (dev, done), b.upload = b.upload, None
        if done is not None:
            record.blocked_waits += int(not done.query())
            cur = torch.cuda.current_stream(b.device)
            cur.wait_event(done)
            for t in dev:
                t.record_stream(cur)
            # the slots are free once the upload, which the compute stream
            # now waits for, has read them
            b.leaves = None
        return dev
