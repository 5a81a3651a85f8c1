"""The page-locked Level-2 slot pool of captured fused segments
(``storage.PinnedSlotPool``), on the CPU: a slot goes back to the pool only
when Level 2, the prefetch staging and the journal have all let go of the
buffers it handed out, over a RAM, a tiered (fast tier of one state) and a
journaled store; the pool grows, counted, only when no slot is free, and
keeps the high-water mark of the slots in use; a store waits while two
earlier ones are pending, which bounds the slots in flight.
"""
import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.storage import (AsyncTransferEngine, HostTree,
                                      PinnedSlotPool, RAMStorage,
                                      make_backend, tree_bytes)

SHAPES = [(4, 3), (4, 3), ()]


def _pool(n=2):
    pool = PinnedSlotPool(SHAPES, torch.float32, pin=False)
    pool.reserve(n)
    return pool


def _fill(leaves, value):
    for t in leaves:
        t.fill_(value)
    return leaves


def test_take_hands_out_fresh_tensors_over_the_slot():
    pool = _pool(2)
    assert (pool.size, pool.free, pool.grown) == (2, 2, 0)
    i, leaves = pool.take()
    assert pool.free == 1
    _fill(leaves, 3.0)
    assert all(torch.equal(a, b) for a, b in zip(leaves, pool.leaves(i)))
    # each leaf owns a storage of exactly its bytes: Level 2 keeps it as
    # it is and counts what it holds
    assert sum(t.untyped_storage().nbytes() for t in leaves) == \
        tree_bytes(leaves) == pool.slot_bytes
    view = leaves[0][1:]   # a view keeps the slot taken
    del leaves
    gc.collect()
    assert pool.free == 1
    del view
    assert pool.free == 2
    j, _ = pool.take()
    assert j in (0, 1) and pool.grown == 0


def test_the_pool_grows_only_when_every_slot_is_taken():
    pool = _pool(1)
    held = [pool.take()[1] for _ in range(3)]
    assert (pool.size, pool.grown, pool.free) == (3, 2, 0)
    assert (pool.in_use, pool.peak) == (3, 3)
    del held
    assert pool.free == 3
    assert (pool.in_use, pool.peak) == (0, 3)
    pool.reset_peak()
    _ = pool.take()
    assert (pool.size, pool.grown, pool.peak) == (3, 2, 1)


def _store_and_read(engine, pool, keys):
    """Store a pooled slot under each key, then wait for the writer."""
    for k in keys:
        _, leaves = pool.take()
        engine.store_async(k, HostTree(_fill(leaves, float(k))))
        del leaves
    engine.wait_stores()


def test_ram_store_keeps_a_slot_until_the_delete_and_the_prefetch():
    pool = _pool(2)
    eng = AsyncTransferEngine(make_backend("ram"), device="cpu")
    _store_and_read(eng, pool, [0])
    assert pool.free == 1                 # Level 2 holds it
    eng.prefetch_async(0)
    staged = eng.wait_prefetch(0)         # on the CPU: over the slot itself
    eng.delete(0)
    assert pool.free == 1                 # the prefetched value still reads it
    assert float(staged[0][0, 0]) == 0.0
    del staged
    assert pool.free == 2
    eng.close()


def test_tiered_eviction_returns_the_slot_once_the_slow_tier_copied_it(
        tmp_path):
    state = tree_bytes([torch.zeros(s) for s in SHAPES])
    pool = _pool(2)
    backend = make_backend("tiered", capacity_bytes=state,
                           directory=str(tmp_path))
    eng = AsyncTransferEngine(backend, device="cpu")
    _store_and_read(eng, pool, [0, 1])   # key 0 spills to disk
    assert backend.evictions == 1 and pool.free == 1
    np.testing.assert_array_equal(backend.slow.get(0)[0], np.zeros((4, 3)))
    eng.delete(1)
    assert pool.free == 2
    eng.close()


def test_journaled_store_returns_the_slot_after_the_logged_delete(tmp_path):
    pool = _pool(2)
    backend = make_backend("ram", journal=str(tmp_path / "wal"))
    backend.begin_run({"plan_id": "test", "n": 2})
    eng = AsyncTransferEngine(backend, device="cpu")
    _store_and_read(eng, pool, [0, 1])
    assert pool.free == 0
    eng.delete_async(0)                  # rides the writer queue
    eng.wait_stores()
    assert pool.free == 1
    assert 1 in backend and 0 not in backend
    np.testing.assert_array_equal(backend.get_exact(1)[0], np.ones((4, 3)))
    eng.delete_async(1)
    eng.wait_stores()
    assert pool.free == 2
    eng.close()
    backend.close()


@pytest.mark.parametrize("kind", ["compressed", "disk"])
def test_copying_stores_return_the_slot_at_the_put(tmp_path, kind):
    """The disk store pickles a copy at the put; the compressed one
    quantises the (h, c) leaves into copies and copies the scalar
    accumulator, which it stores raw: either returns the slot at once."""
    pool = PinnedSlotPool([(16, 8), (16, 8), ()], torch.float32, pin=False)
    pool.reserve(1)
    kw = {"directory": str(tmp_path)} if kind == "disk" else {}
    eng = AsyncTransferEngine(make_backend(kind, **kw), device="cpu")
    _store_and_read(eng, pool, [0])
    gc.collect()
    assert pool.free == 1
    eng.delete(0)
    assert pool.free == 1
    eng.close()


def test_a_store_waits_while_two_are_pending():
    """The caller runs at most ``MAX_PENDING_STORES`` (2) stores ahead of
    the writer: a third store waits until the backend has taken the first,
    so the pooled slots in flight stay few whatever the device's pace."""
    gate = threading.Event()

    class SlowRAM(RAMStorage):
        def put(self, key, val):
            gate.wait()
            super().put(key, val)

    pool = _pool(3)
    backend = SlowRAM()
    eng = AsyncTransferEngine(backend, device="cpu")
    assert eng.MAX_PENDING_STORES == 2
    for k in (0, 1):
        eng.store_async(k, HostTree(_fill(pool.take()[1], float(k))))
    third = threading.Event()

    def store_third():
        eng.store_async(2, HostTree(_fill(pool.take()[1], 2.0)))
        third.set()

    t = threading.Thread(target=store_third)
    t.start()
    assert not third.wait(0.3)           # two pending: the third waits
    gate.set()
    assert third.wait(10.0)
    t.join()
    eng.wait_stores()
    assert sorted(backend.keys()) == [0, 1, 2]
    assert eng.store_stall_s > 0
    eng.close()
