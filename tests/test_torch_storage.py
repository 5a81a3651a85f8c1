"""The RAM-backend protocol and concurrency cases of
``tests/test_storage_backends.py``, run against the port's Level-2 store
(``repro_torch.core.storage``), plus its tensor paths on the CPU."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import storage
from repro_torch.core.storage import (AsyncTransferEngine, HostTree,
                                      RAMStorage, WriterCrashError,
                                      tree_bytes)


class FailingBackend(RAMStorage):
    def __init__(self, fail_puts=True, fail_gets=False):
        super().__init__()
        self.fail_puts = fail_puts
        self.fail_gets = fail_gets

    def put(self, key, tree):
        if self.fail_puts:
            raise IOError(f"put({key}) failed")
        super().put(key, tree)

    def get(self, key):
        if self.fail_gets:
            raise IOError(f"get({key}) failed")
        return super().get(key)


def _tree():
    return {"a": np.ones((4, 4), np.float32)}


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_store_wait_prefetch_delete_roundtrip():
    eng = AsyncTransferEngine(RAMStorage())
    tree = {"h": np.arange(6, dtype=np.float32), "acc": np.float32(2.5)}
    eng.store_async(0, tree)
    eng.wait_stores()
    assert 0 in eng.backend and eng.num_stores == 1
    eng.prefetch_async(0)
    got = eng.wait_prefetch(0)
    np.testing.assert_array_equal(got["h"], tree["h"])
    assert float(got["acc"]) == 2.5
    eng.delete(0)
    assert 0 not in eng.backend and eng.backend.live_bytes == 0
    assert eng.backend.peak_bytes == tree_bytes(tree)
    eng.close()


def test_store_error_surfaces_on_wait_stores():
    eng = AsyncTransferEngine(FailingBackend())
    eng.store_async(0, _tree())
    with pytest.raises(IOError, match="put"):
        eng.wait_stores()
    eng.close()


def test_store_error_surfaces_on_demand_fetch():
    eng = AsyncTransferEngine(FailingBackend())
    eng.store_async(0, _tree())
    eng._join_stores()
    with pytest.raises(IOError, match="put"):
        eng.wait_prefetch(0)   # never prefetched -> demand path
    eng.close()


def test_prefetch_error_surfaces_on_wait():
    eng = AsyncTransferEngine(FailingBackend(fail_puts=False, fail_gets=True))
    eng.store_async(0, _tree())
    eng.wait_stores()
    eng.prefetch_async(0)
    with pytest.raises(IOError, match="get"):
        eng.wait_prefetch(0)
    eng.close()


def test_close_survives_dead_writer():
    """close() must not deadlock when the writer thread died with items
    still queued — it times out, raises, and leaves no thread."""
    eng = AsyncTransferEngine(RAMStorage())
    eng._stop.set()            # simulate writer death
    eng._writer.join(timeout=2.0)
    assert not eng._writer.is_alive()
    eng.store_async(0, _tree())   # lands in the queue, never drained
    with pytest.raises(WriterCrashError, match="writer thread died"):
        eng.close()


def test_close_is_idempotent_after_error():
    eng = AsyncTransferEngine(FailingBackend())
    eng.store_async(0, _tree())
    with pytest.raises(IOError):
        eng.wait_stores()
    eng.close()
    eng.close()


def test_engine_counters_threadsafe():
    eng = AsyncTransferEngine(RAMStorage())
    tree = {"a": np.ones((8,), np.float32)}
    n_threads, n_keys = 8, 40

    def stores(tid):
        for i in range(n_keys):
            eng.store_async((tid, i), tree)

    threads = [threading.Thread(target=stores, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    eng.wait_stores()
    assert eng.num_stores == n_threads * n_keys

    def prefetches(tid):
        for i in range(n_keys):
            eng.prefetch_async((tid, i))

    threads = [threading.Thread(target=prefetches, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert eng.num_prefetches == n_threads * n_keys
    for tid in range(n_threads):
        for i in range(n_keys):
            np.testing.assert_array_equal(
                eng.wait_prefetch((tid, i))["a"], tree["a"])
    eng.close()


def test_delete_invalidates_staged_prefetch():
    """delete + re-store + prefetch must observe the NEW value."""
    eng = AsyncTransferEngine(RAMStorage())
    eng.store_async(0, {"a": np.full((4,), 1.0, np.float32)})
    eng.wait_stores()
    eng.prefetch_async(0)
    assert _wait_for(lambda: 0 in eng._prefetched)
    eng.delete(0)
    eng.store_async(0, {"a": np.full((4,), 2.0, np.float32)})
    eng.wait_stores()
    eng.prefetch_async(0)
    got = eng.wait_prefetch(0)
    np.testing.assert_array_equal(got["a"], np.full((4,), 2.0, np.float32))
    eng.close()


def test_delete_detaches_inflight_prefetch():
    release = threading.Event()

    class SlowBackend(RAMStorage):
        def get(self, key):
            release.wait(5.0)
            return super().get(key)

    eng = AsyncTransferEngine(SlowBackend())
    eng.store_async(0, {"a": np.full((4,), 1.0, np.float32)})
    eng.wait_stores()
    eng.prefetch_async(0)          # blocked in SlowBackend.get
    eng.delete(0)                  # detaches the in-flight job
    eng.store_async(0, {"a": np.full((4,), 2.0, np.float32)})
    eng.wait_stores()
    release.set()                  # stale job completes -> must be discarded
    eng.prefetch_async(0)
    got = eng.wait_prefetch(0)
    np.testing.assert_array_equal(got["a"], np.full((4,), 2.0, np.float32))
    eng.close()


def test_close_drops_leaked_staged_prefetches():
    eng = AsyncTransferEngine(RAMStorage())
    for k in range(3):
        eng.store_async(k, {"a": np.ones((4,), np.float32)})
    eng.wait_stores()
    for k in range(3):
        eng.prefetch_async(k)
    assert _wait_for(lambda: len(eng._prefetched) == 3)
    assert eng.staged_bytes > 0
    eng.close()
    assert eng._prefetched == {} and eng._prefetch_events == {}
    assert eng.staged_bytes == 0


def test_ram_get_mutation_cannot_corrupt_checkpoint():
    store = RAMStorage()
    store.put("k", {"a": np.arange(6, dtype=np.float32)})
    got = store.get("k")
    with pytest.raises(ValueError):
        got["a"][0] = 99.0
    np.testing.assert_array_equal(
        store.get("k")["a"], np.arange(6, dtype=np.float32))


def test_staged_prefetch_bytes_accounted():
    eng = AsyncTransferEngine(RAMStorage())
    tree = {"a": np.ones((16,), np.float32)}
    nb = tree_bytes(tree)
    for k in range(2):
        eng.store_async(k, tree)
    eng.wait_stores()
    for k in range(2):
        eng.prefetch_async(k)
    assert _wait_for(lambda: eng.staged_bytes >= 2 * nb)
    assert eng.staged_bytes == 2 * nb
    assert eng.staged_peak_bytes == 2 * nb
    eng.wait_prefetch(0)
    eng.wait_prefetch(1)
    assert eng.staged_bytes == 0
    assert eng.staged_peak_bytes == 2 * nb
    eng.close()


# ------------------------------------------------------- tensor paths


def test_tensor_store_is_a_snapshot():
    """A stored tensor is detached from Level 1: mutating the source after
    store_async never reaches the checkpoint."""
    eng = AsyncTransferEngine(RAMStorage(), device="cpu")
    src = (torch.arange(4.0), torch.tensor(1.0))
    eng.store_async(0, src)
    src[0].add_(100.0)
    eng.wait_stores()
    got = eng.wait_prefetch(0)
    assert isinstance(got[0], torch.Tensor)
    torch.testing.assert_close(got[0], torch.arange(4.0))
    assert tree_bytes(got) == tree_bytes(src) == 20
    eng.close()


def test_host_tree_buffers_become_the_level2_copy():
    """A kernel-written HostTree is stored without a copy, read-only, and
    read back intact."""
    buf = torch.arange(6.0).reshape(2, 3)
    eng = AsyncTransferEngine(RAMStorage(), device="cpu")
    eng.store_async(7, HostTree((buf[0], buf[1, 0])))
    eng.wait_stores()
    stored = eng.backend.get(7)
    assert not stored[0].flags.writeable
    assert np.shares_memory(stored[0], buf.numpy())
    with pytest.raises(ValueError):
        stored[0][0] = 5.0
    got = eng.wait_prefetch(7)
    torch.testing.assert_close(got[0], torch.tensor([0.0, 1.0, 2.0]))
    assert float(got[1]) == 3.0
    eng.close()


def test_delete_async_rides_the_writer_queue():
    """delete_async invalidates a staged prefetch at once and deletes the
    key behind the stores queued before it (FIFO)."""
    eng = AsyncTransferEngine(RAMStorage())
    eng.store_async(0, _tree())
    eng.wait_stores()
    eng.prefetch_async(0)
    assert _wait_for(lambda: 0 in eng._prefetched)
    eng.store_async(1, _tree())
    eng.delete_async(0)
    assert 0 not in eng._prefetched and eng.staged_bytes == 0
    eng.wait_stores()
    assert 0 not in eng.backend and 1 in eng.backend
    eng.close()


def _bf16_state(seed=0):
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.standard_normal((2, 5, 8)).astype(np.float32))
    return h.to(torch.bfloat16), torch.tensor(1.25)


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


@pytest.mark.parametrize("handover", ["snapshot", "host_tree"])
def test_bf16_state_round_trips_bit_exactly(handover):
    """A bf16 carry (the transformer chain's hidden state) stored,
    prefetched and read back is bit-identical, and Level 2 counts 2 bytes
    per element — the JAX package's ``l2_peak_bytes`` for the same plan."""
    h, acc = _bf16_state()
    nbytes = h.numel() * 2 + 4
    assert tree_bytes((h, acc)) == nbytes
    eng = AsyncTransferEngine(RAMStorage(), device="cpu")
    if handover == "snapshot":
        eng.store_async(0, (h, acc))
    else:   # a kernel's page-locked buffers, handed over without a copy
        eng.store_async(0, HostTree((h.clone(), acc.clone())))
    eng.wait_stores()
    assert eng.backend.live_bytes == eng.backend.peak_bytes == nbytes
    stored = eng.backend.get(0)
    assert isinstance(stored[0], storage.Bits)
    assert stored[0].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        stored[0].array[0, 0, 0] = 0    # the checkpoint stays read-only
    eng.prefetch_async(0)
    got = eng.wait_prefetch(0)
    assert _same_bits(got[0], h) and float(got[1]) == 1.25
    eng.delete(0)
    assert eng.backend.live_bytes == 0
    eng.close()


def test_bf16_put_get_and_demand_fetch():
    h, acc = _bf16_state(1)
    store = RAMStorage()
    store.put("k", {"h": h, "acc": acc})
    assert store.bytes_written == h.numel() * 2 + 4
    h[0, 0, 0] = 7.0   # the store took a copy
    eng = AsyncTransferEngine(store, device="cpu")
    got = eng.wait_prefetch("k")   # never prefetched: demand path
    assert _same_bits(got["h"], _bf16_state(1)[0])
    eng.close()
