# Copy of repro/core/journal.py: the record format is byte-compatible.
"""Write-ahead journal file format for crash-consistent Level-2 storage.

One append-only binary file records every Level-2 mutation of a multistage
run: ``STORE``/``DELETE`` of boundary states (payload = pickled host
pytree), ``CURSOR`` checkpoints of the executor's plan position, and
``BEGIN``/``END`` markers bracketing one gradient run (an *epoch*).  Each
record carries a CRC-32 of its key+payload.  Durability is **group
commit** at segment granularity: bulk records (``STORE``/``DELETE``) may
defer their fsync (``append(..., sync=False)``), and the next commit
barrier — a ``CURSOR``/``BEGIN``/``END`` append or an explicit
:meth:`JournalFile.flush` — fsyncs the shared fd, landing every deferred
record before it.  Prefix semantics are preserved: by the time a cursor is
durable, every store written before it is durable too, so a recovered
cursor can never claim a non-durable boundary (the fsync-per-record WAL
guarantee at ~one fsync per segment instead of one per record).

Record layout (little-endian)::

    magic   4s   b"RJ1\\0"
    op      B    1=BEGIN 2=STORE 3=DELETE 4=CURSOR 5=END
    key_len I    length of the pickled key
    pay_len Q    length of the payload
    crc     I    crc32(op_byte + key_bytes + payload_bytes)
    hcrc    I    crc32 of the preceding header bytes (framing guard)
    key     key_len bytes
    payload pay_len bytes

``hcrc`` exists so the damage taxonomy below cannot be fooled by bit rot
in a *length* field: without it, a flipped ``pay_len`` would make the
record extend past EOF and be misclassified as a torn tail (silently
truncated) instead of surfacing as checksum damage.

Damage model (what :func:`scan` distinguishes):

* a record whose header or body extends past EOF is **torn** — the
  expected artifact of a crash mid-``write``; the valid prefix ends at the
  record's start and the tail is discardable (``JournaledStorage``
  truncates it on open);
* a *complete* record whose CRC does not match is a **checksum** failure —
  bit rot or tampering, never produced by a clean crash; surfaced as a
  typed :class:`~repro_torch.core.faults.ChecksumError` unless the caller asked
  for repair (truncate back to the last good record).

Everything after the first damaged record is suspect (framing may be
lost), so the valid prefix always ends there — standard WAL semantics.

The file is accessed through ``os.pread``/``os.pwrite`` on a single fd so
concurrent readers (prefetch threads re-hydrating states) never race the
appender's file position.
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.faults import ChecksumError, TornRecordError

MAGIC = b"RJ1\x00"
OP_BEGIN, OP_STORE, OP_DELETE, OP_CURSOR, OP_END = 1, 2, 3, 4, 5
OP_NAMES = {OP_BEGIN: "BEGIN", OP_STORE: "STORE", OP_DELETE: "DELETE",
            OP_CURSOR: "CURSOR", OP_END: "END"}

_HEADER = struct.Struct("<4sBIQII")  # magic, op, key_len, pay_len, crc, hcrc

# The commit barrier primitive.  fdatasync flushes the data and the
# metadata needed to read it back (file size) but skips timestamp-only
# metadata — measurably cheaper per barrier than fsync on journaling
# filesystems, with identical WAL durability for an append-only log.
_sync_fd = getattr(os, "fdatasync", os.fsync)


def _crc(op: int, key: bytes, payload: bytes) -> int:
    c = zlib.crc32(bytes([op]))
    c = zlib.crc32(key, c)
    return zlib.crc32(payload, c)


def _pack_header(op: int, key: bytes, payload: bytes) -> bytes:
    head = struct.pack("<4sBIQI", MAGIC, op, len(key), len(payload),
                       _crc(op, key, payload))
    return head + struct.pack("<I", zlib.crc32(head))


def _unpack_header(header: bytes):
    """Returns (op, key_len, pay_len, crc) or None when the framing
    fields themselves fail their CRC (bit rot in the header)."""
    magic, op, key_len, pay_len, crc, hcrc = _HEADER.unpack(header)
    if magic != MAGIC or zlib.crc32(header[:-4]) != hcrc:
        return None
    return op, key_len, pay_len, crc


@dataclass(frozen=True)
class Record:
    """One decoded journal record; ``payload_off`` locates the raw payload
    bytes in the file so large states can be re-read lazily."""

    op: int
    key: Any
    payload: bytes
    start: int          # file offset of the record header
    payload_off: int    # file offset of the payload bytes
    end: int            # file offset one past the record


@dataclass(frozen=True)
class Damage:
    """Where and how a scan stopped trusting the journal."""

    kind: str       # "torn" | "checksum"
    offset: int     # start of the damaged record == end of the valid prefix
    detail: str = ""


@dataclass
class ScanResult:
    records: List[Record] = field(default_factory=list)
    damage: Optional[Damage] = None
    valid_end: int = 0   # offset one past the last intact record


@dataclass(frozen=True)
class RecoveredRun:
    """What survived the crash, as reconstructed from the journal's last
    epoch: the durable boundary keys (journal order == store order), the
    last plan cursor, and any per-segment reverse artifacts the executor
    checkpointed alongside it (e.g. per-step input cotangents).

    ``keys`` + ``cursor`` imply the plan position a resume can restart
    from: forward resumes replay from the largest durable boundary (at
    most one interval behind the cursor), reverse resumes restart at
    ``cursor.segment_index`` with the cursor's adjoint — see
    ``CheckpointExecutor.multistage_forward(resume_from=...)``.
    """

    keys: Tuple[Any, ...]
    cursor: Any = None                      # last RunCursor, or None
    artifacts: Dict[Any, Any] = None        # segment begin -> reverse artifact
    meta: Dict[str, Any] = None             # BEGIN record metadata
    torn: bool = False                      # a torn tail was discarded on open
    journal_bytes: int = 0

    def __post_init__(self):
        object.__setattr__(self, "artifacts", dict(self.artifacts or {}))
        object.__setattr__(self, "meta", dict(self.meta or {}))


class JournalFile:
    """The raw record file: append (durable), pread, scan, truncate.

    Thread-safe: one lock serialises appends/truncations; reads go through
    ``os.pread`` and never touch the shared file position.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self._lock = threading.Lock()
        self._end = os.fstat(self._fd).st_size
        self._dirty = False      # pwrite'd bytes not yet fsync'd
        self.fsync_count = 0     # instrumentation: actual fsync calls

    # ------------------------------------------------------------------ write
    def append(self, op: int, key: bytes = b"", payload: bytes = b"",
               *, sync: Optional[bool] = None) -> Tuple[int, int]:
        """Append one record; returns its ``(start, end)`` extent.

        ``sync=None`` (default) fsyncs per the file's ``fsync`` setting —
        the classic one-fsync-per-record WAL.  ``sync=False`` defers the
        fsync: the bytes are written (visible to in-process ``pread``)
        but only made durable by the next syncing append or an explicit
        :meth:`flush` — the group-commit path.  ``sync=True`` forces a
        commit barrier: because all records share one fd, this fsync also
        lands every deferred record written before it (WAL prefix
        semantics are preserved — a durable barrier implies a durable
        prefix).  ``fsync=False`` files never sync regardless of ``sync``.
        """
        data = _pack_header(op, key, payload) + key + payload
        with self._lock:
            start = self._end
            os.pwrite(self._fd, data, start)
            do_sync = self.fsync if sync is None else (sync and self.fsync)
            if do_sync:
                _sync_fd(self._fd)
                self.fsync_count += 1
                self._dirty = False
            else:
                self._dirty = True
            self._end = start + len(data)
            return start, self._end

    def flush(self) -> None:
        """Group-commit barrier: fsync any deferred appends (no-op when
        nothing is pending or the file runs with ``fsync=False``)."""
        with self._lock:
            if self._dirty and self.fsync:
                _sync_fd(self._fd)
                self.fsync_count += 1
            self._dirty = False

    def truncate(self, offset: int) -> None:
        with self._lock:
            os.ftruncate(self._fd, offset)
            if self.fsync:
                _sync_fd(self._fd)
                self.fsync_count += 1
            self._dirty = False
            self._end = offset

    # ------------------------------------------------------------------- read
    def pread(self, length: int, offset: int) -> bytes:
        return os.pread(self._fd, length, offset)

    @property
    def size(self) -> int:
        with self._lock:
            return self._end

    def scan(self) -> ScanResult:
        """Decode records from offset 0 until EOF or the first damage."""
        out = ScanResult()
        size = os.fstat(self._fd).st_size
        off = 0
        while off < size:
            header = self.pread(_HEADER.size, off)
            if len(header) < _HEADER.size:
                out.damage = Damage("torn", off, "truncated header")
                break
            decoded = _unpack_header(header)
            if decoded is None or decoded[0] not in OP_NAMES:
                # the header CRC separates bit rot in framing fields from
                # a genuinely short tail: a complete-but-rotted header is
                # corruption, never a crash artifact
                out.damage = Damage("checksum", off,
                                    f"header at {off} fails its CRC")
                break
            op, key_len, pay_len, crc = decoded
            body_off = off + _HEADER.size
            end = body_off + key_len + pay_len
            if end > size:
                out.damage = Damage("torn", off, "truncated body")
                break
            body = self.pread(key_len + pay_len, body_off)
            key_b, payload = body[:key_len], body[key_len:]
            if _crc(op, key_b, payload) != crc:
                out.damage = Damage(
                    "checksum", off,
                    f"{OP_NAMES[op]} record at {off} fails its CRC")
                break
            key = pickle.loads(key_b) if key_b else None
            out.records.append(Record(op=op, key=key, payload=payload,
                                      start=off,
                                      payload_off=body_off + key_len,
                                      end=end))
            out.valid_end = end
            off = end
        return out

    def read_payload(self, rec_off: int) -> bytes:
        """Re-read (and re-verify) one record's payload by header offset —
        used to serve ``get`` lazily from the journal after recovery."""
        header = self.pread(_HEADER.size, rec_off)
        if len(header) < _HEADER.size:
            raise TornRecordError(
                f"journal record at {rec_off} is truncated")
        decoded = _unpack_header(header)
        if decoded is None:
            raise ChecksumError(
                f"journal record at {rec_off}: header fails its CRC")
        op, key_len, pay_len, crc = decoded
        body = self.pread(key_len + pay_len, rec_off + _HEADER.size)
        if len(body) < key_len + pay_len:
            raise TornRecordError(
                f"journal record at {rec_off} is truncated")
        key_b, payload = body[:key_len], body[key_len:]
        if _crc(op, key_b, payload) != crc:
            raise ChecksumError(
                f"journal {OP_NAMES.get(op, op)} record at {rec_off} "
                "fails its CRC (torn or corrupted)")
        return payload

    def close(self) -> None:
        with self._lock:
            if self._fd >= 0:
                os.close(self._fd)
                self._fd = -1

    # -- fault-injection hooks (tests only) -----------------------------------
    def debug_flip_byte(self, offset: int) -> None:
        """Flip one byte in place (simulated bit rot)."""
        b = self.pread(1, offset)
        if b:
            os.pwrite(self._fd, bytes([b[0] ^ 0xFF]), offset)
            if self.fsync:
                _sync_fd(self._fd)

    def debug_truncate(self, offset: int) -> None:
        """Tear the file mid-record (simulated crash mid-write)."""
        self.truncate(offset)


def iter_epoch(records: List[Record]) -> Iterator[Record]:
    """Yield the records of the *last* epoch (after the final BEGIN)."""
    start = 0
    for i, rec in enumerate(records):
        if rec.op == OP_BEGIN:
            start = i
    return iter(records[start:])
