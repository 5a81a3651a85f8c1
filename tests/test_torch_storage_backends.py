"""The port's Level-2 backends (disk, int8-compressed, capacity-bounded
tiered and namespaced; the backend registry) against the JAX package's, on
the CPU at small sizes with inputs made from a seed with numpy.

* the codec: ``quantize_np``/``dequantize_np`` bit-equal to the JAX
  package's;
* ``CompressedStorage``: decoded values, int8 payloads and scales bit-equal
  (the pickled-structure leaf differs by framework and is left out); int,
  small and bf16 leaves returned bit for bit;
* ``TieredStorage``: one scripted sequence of ``put``/``get``/``peek``/
  ``delete``/``set_plan`` fed to both gives equal counters and the same
  keys in each tier (a hypothesis sweep plus the reference's unit cases);
  its write-behind races and the tenant quota and namespace units of
  ``tests/test_serve.py`` on the port's storage alone;
* end to end: ``lstm-paper`` SMOKE with the JAX package's weights through
  both packages' ``value_and_grad_offloaded`` with the same storage
  options (the port's compiled and fused runners against JAX's compiled
  runner): plans and Level-2 counters equal, the loss within 1e-5, grads
  within 1e-4 (disk, tiered), and compressed within the reference's own
  bound of dense autograd (error above 0 and below 5e-2);
* the autotuner's slow-tier probe and the front door's errors.
"""
import math
import os
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import api as j_api
from repro.configs import base as j_base
from repro.configs.registry import get_config as j_get_config
from repro.configs.shapes import make_batch as j_make_batch
from repro.core import schedule as j_ms
from repro.core import storage as j_storage
from repro.distributed import compression as j_comp
from repro.models.model_factory import get_model as j_get_model
from repro_torch import api
from repro_torch.api import autotune as at
from repro_torch.api import frontend as fe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import perfmodel
from repro_torch.core import schedule as ms
from repro_torch.core import storage
from repro_torch.core.faults import ChecksumError
from repro_torch.core.storage import (AsyncTransferEngine, Bits,
                                      CompressedStorage, DiskStorage,
                                      HostTree, JournaledStorage,
                                      NamespacedStorage, RAMStorage,
                                      TieredStorage, make_backend,
                                      register_backend, tree_bytes)
from repro_torch.distributed import compression as comp
from repro_torch.models import lstm
from repro_torch.models.model_factory import get_model


# ---------------------------------------------------------------------------
# registry (tests/test_storage_backends.py:29-82)
# ---------------------------------------------------------------------------


def test_make_backend_kinds():
    assert isinstance(make_backend("ram"), RAMStorage)
    assert make_backend("ram", bandwidth=1e6).bandwidth == 1e6
    with tempfile.TemporaryDirectory() as d:
        assert isinstance(make_backend("disk", directory=d), DiskStorage)
        comp_disk = make_backend("compressed", directory=d)
        assert isinstance(comp_disk.inner, DiskStorage)
        ts = make_backend("tiered", capacity_bytes=1024, directory=d)
        assert isinstance(ts.slow, DiskStorage)
    comp_ram = make_backend("compressed")
    assert isinstance(comp_ram, CompressedStorage)
    assert isinstance(comp_ram.inner, RAMStorage)
    ts = make_backend("tiered", capacity_bytes=1024)
    assert isinstance(ts, TieredStorage) and isinstance(ts.slow, RAMStorage)
    with pytest.raises(ValueError, match="capacity_bytes"):
        TieredStorage(capacity_bytes=0)


def test_make_backend_unknown():
    with pytest.raises(ValueError, match="unknown Level-2 backend"):
        make_backend("tape")


@pytest.mark.parametrize("kw,item", [
    # the ids the cases had while journal= was a left-out knob too
    pytest.param({"shards": 2}, "item 15", id="kw1-item 15"),
])
def test_make_backend_left_out_knobs_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        make_backend("ram", **kw)


@pytest.mark.parametrize("kind", ["ram", "disk", "compressed", "tiered"])
def test_make_backend_journal_wraps_every_kind(tmp_path, kind):
    """``journal=`` (a left-out knob until the journal was ported) wraps
    each kind in a JournaledStorage, as the JAX package's does."""
    kw = {"disk": {"directory": str(tmp_path / "l2")},
          "tiered": {"capacity_bytes": 64}}.get(kind, {})
    js = make_backend(kind, journal=str(tmp_path / "wal"), **kw)
    ref = j_storage.make_backend(kind, journal=str(tmp_path / "j_wal"),
                                 **kw)
    assert isinstance(js, JournaledStorage)
    assert type(js.inner).__name__ == type(ref.inner).__name__
    js.put(0, _jtree(1))
    np.testing.assert_array_equal(np.asarray(js.get(0)["a"]),
                                  _jtree(1)["a"])
    js.close()
    ref.close()


def test_register_backend_custom():
    register_backend("null-test", lambda: RAMStorage())
    assert isinstance(make_backend("null-test"), RAMStorage)


def test_registered_backend_reachable_from_frontend():
    """A kind added with register_backend works through the front door:
    the port delegates storage validation to the registry, as the JAX
    package does."""
    instances = []

    def factory():
        b = RAMStorage()
        instances.append(b)
        return b

    register_backend("tracking-ram", factory)
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.standard_normal((4, 4)).astype(np.float32) * 0.3)
    xs = torch.as_tensor(rng.standard_normal((16, 2, 4)).astype(np.float32)
                         * 0.1)

    def body(p, c, x):
        c = torch.tanh(c @ p["W"] + x)
        return c, (c ** 2).sum()

    bptt = api.checkpointed_bptt(body, interval=4, slots=2,
                                 storage="tracking-ram", device="cpu")
    bptt({"W": w}, torch.zeros(2, 4), xs)
    assert instances and instances[-1].bytes_written > 0
    with pytest.raises(ValueError, match="unknown Level-2 backend"):
        api.checkpointed_bptt(body, interval=4, slots=2, storage="tape",
                              device="cpu")({"W": w}, torch.zeros(2, 4), xs)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "wide", "zeros", "tiny"])
def test_codec_bit_equal_to_jax(case):
    rng = np.random.default_rng(11)
    x = {"normal": rng.standard_normal((64, 33)),
         "wide": rng.standard_normal(1000) * 1e4,
         "zeros": np.zeros((8, 8)),
         "tiny": rng.standard_normal(7) * 1e-20}[case].astype(np.float32)
    q, s = comp.quantize_np(x)
    jq, js = j_comp.quantize_np(x)
    assert q.dtype == jq.dtype == np.int8 and type(s) is type(js)
    np.testing.assert_array_equal(q, jq)
    assert s.tobytes() == js.tobytes()
    d, jd = comp.dequantize_np(q, s), j_comp.dequantize_np(jq, js)
    assert d.dtype == jd.dtype and d.tobytes() == jd.tobytes()
    bound = comp.quantization_error_bound(x)
    assert bound == j_comp.quantization_error_bound(jnp.asarray(x))
    assert float(np.max(np.abs(d - x))) <= bound


# ---------------------------------------------------------------------------
# CompressedStorage
# ---------------------------------------------------------------------------


def _compressed_trees():
    rng = np.random.default_rng(3)
    big = rng.standard_normal((64, 64)).astype(np.float32)
    nested = (rng.standard_normal((32, 32)) * 7.0).astype(np.float32)
    bf16 = rng.standard_normal((16, 16)).astype(np.float32)
    small = np.ones(3, np.float32)
    ints = np.arange(512, dtype=np.int32)
    port = {"big_f32": big, "small_f32": small, "ints": ints,
            "nested": (nested,),
            "bf16": torch.as_tensor(bf16).to(torch.bfloat16)}
    ref = {"big_f32": big, "small_f32": small, "ints": ints,
           "nested": (nested,),
           "bf16": bf16.astype(ml_dtypes.bfloat16)}
    # keys in sorted order: torch's pytree flattens a dict in insertion
    # order, JAX's in sorted order, and the payloads are compared leaf by
    # leaf
    return dict(sorted(port.items())), dict(sorted(ref.items()))


def test_compressed_round_trip_matches_jax():
    port_tree, ref_tree = _compressed_trees()
    ours = CompressedStorage(min_bytes=256)
    ref = j_storage.CompressedStorage(min_bytes=256)
    ours.put("k", port_tree)
    ref.put("k", ref_tree)
    got, jgot = ours.get("k"), ref.get("k")
    for name in ("big_f32", "small_f32", "ints"):
        assert got[name].dtype == jgot[name].dtype, name
        assert got[name].tobytes() == np.asarray(jgot[name]).tobytes(), name
    assert got["nested"][0].tobytes() == \
        np.asarray(jgot["nested"][0]).tobytes()
    np.testing.assert_array_equal(got["ints"], ref_tree["ints"])
    np.testing.assert_array_equal(got["small_f32"], ref_tree["small_f32"])
    # bf16 stays raw in both (ml_dtypes' kind 'V', the port's Bits)
    assert isinstance(got["bf16"], Bits)
    assert got["bf16"].array.tobytes() == ref_tree["bf16"].tobytes()
    assert np.asarray(jgot["bf16"]).tobytes() == ref_tree["bf16"].tobytes()
    bound = comp.quantization_error_bound(ref_tree["big_f32"])
    assert float(np.max(np.abs(got["big_f32"] - ref_tree["big_f32"]))) \
        <= bound
    # the encoded payloads: int8 and scales byte-equal, trailing structure
    # leaf excluded
    enc, jenc = ours.inner.get("k")[:-1], ref.inner.get("k")[:-1]
    assert len(enc) == len(jenc)
    for a, b in zip(enc, jenc):
        if isinstance(b, tuple):
            assert isinstance(a, tuple)
            assert a[0].tobytes() == b[0].tobytes()
            assert np.asarray(a[1]).tobytes() == np.asarray(b[1]).tobytes()
            assert a[2].dtype == b[2].dtype
        else:
            assert not isinstance(a, tuple)
    td = ours.inner.get("k")[-1].nbytes
    jtd = ref.inner.get("k")[-1].nbytes
    assert ours.bytes_written - td == ref.bytes_written - jtd
    assert ours.raw_bytes == ref.raw_bytes
    assert ours.bytes_written < 0.5 * ours.raw_bytes
    ours.delete("k")
    assert "k" not in ours and ours.live_bytes == 0


def test_compressed_raw_bytes_counter_threadsafe():
    store = CompressedStorage(min_bytes=1 << 30)   # raw passthrough
    tree = {"a": np.ones((32,), np.float32)}
    nb = tree_bytes(tree)

    def hammer(tid):
        for i in range(50):
            store.put((tid, i), tree)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert store.raw_bytes == 8 * 50 * nb


# ---------------------------------------------------------------------------
# DiskStorage
# ---------------------------------------------------------------------------


def test_disk_round_trip_fresh_arrays_and_bits(tmp_path):
    disk = DiskStorage(str(tmp_path))
    bf16 = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    tree = {"h": np.arange(6, dtype=np.float32),
            "t": torch.arange(4, dtype=torch.float32),
            "bf": bf16.to(torch.bfloat16)}
    disk.put(0, tree)
    assert os.listdir(tmp_path) == ["ckpt_0.pkl"]   # published, no .tmp
    a, b = disk.get(0), disk.get(0)
    assert a["h"] is not b["h"] and a["h"].flags.writeable
    np.testing.assert_array_equal(a["h"], tree["h"])
    np.testing.assert_array_equal(a["t"], np.arange(4, dtype=np.float32))
    assert isinstance(a["bf"], Bits) and a["bf"].dtype == torch.bfloat16
    assert torch.equal(storage._host_tensor(a["bf"]), tree["bf"])
    assert disk.live_bytes == disk.peak_bytes == tree_bytes(tree)
    disk.delete(0)
    assert os.listdir(tmp_path) == [] and disk.live_bytes == 0


# ---------------------------------------------------------------------------
# TieredStorage against the JAX package's
# ---------------------------------------------------------------------------

SIZES = ((4, 4), (2, 4), (8, 4))   # 64, 32 and 128 bytes


def _state(v, shape=(4, 4)):
    return {"a": np.full(shape, float(v), np.float32)}


_NB = tree_bytes(_state(0))
COUNTERS = ("evictions", "promotions", "fast_hits", "slow_hits",
            "fast_peak_bytes", "fast_live_bytes", "untracked_keys",
            "bytes_written", "bytes_read")


def _pair(capacity, **kw):
    return (TieredStorage(capacity, **kw),
            j_storage.TieredStorage(capacity, **kw))


def _plans(n, interval, s):
    return ms.segment_plan(n, interval, s), j_ms.segment_plan(n, interval, s)


def _assert_tiers_equal(ours, ref, counters=COUNTERS):
    for name in counters:
        assert getattr(ours, name) == getattr(ref, name), name
    assert set(ours._fast) == set(ref._fast)
    assert set(ours._writing) == set(ref._writing)
    assert set(ours.slow.keys()) == set(ref.slow.keys())


def _run_script(ours, ref, script):
    """Apply one op list to both stores, comparing after each op."""
    for op, *args in script:
        if op == "put":
            key, v, shape = args
            ours.put(key, _state(v, shape))
            ref.put(key, _state(v, shape))
        elif op in ("get", "peek"):
            key = args[0]
            assert (key in ours) == (key in ref)
            if key not in ours:
                continue
            a = getattr(ours, op)(key)["a"]
            b = np.asarray(getattr(ref, op)(key)["a"])
            assert a.tobytes() == b.tobytes() and a.shape == b.shape
            with pytest.raises(ValueError):
                a[(0,) * a.ndim] = 99.0   # read-only either way
        elif op == "delete":
            ours.delete(args[0])
            ref.delete(args[0])
        elif op in ("plan", "rplan"):
            # a SegmentPlan, or its ResourceAccessPlan (distances())
            p, jp = _plans(*args)
            if op == "rplan":
                p, jp = (p.resource_access_plan(_NB),
                         jp.resource_access_plan(_NB))
            ours.set_plan(p)
            ref.set_plan(jp)
            assert ours.plan_prefetch_distance(p) == \
                ref.plan_prefetch_distance(jp)
        _assert_tiers_equal(ours, ref)
        assert ours.live_bytes == ref.live_bytes
        assert ours.fast_live_bytes <= ours.capacity_bytes


_OPS = st.one_of(
    st.tuples(st.just("put"), st.integers(0, 7), st.integers(0, 99),
              st.sampled_from(SIZES)),
    st.tuples(st.just("get"), st.integers(0, 7)),
    st.tuples(st.just("peek"), st.integers(0, 7)),
    st.tuples(st.just("delete"), st.integers(0, 7)),
    st.tuples(st.sampled_from(["plan", "rplan"]), st.integers(1, 8),
              st.integers(1, 3), st.integers(1, 2)))


@settings(max_examples=60, deadline=None)
@given(capacity=st.integers(16, 400), script=st.lists(_OPS, max_size=40))
def test_tiered_script_sweep_matches_jax(capacity, script):
    _run_script(*_pair(capacity), script)


def _belady_mixed():
    # boundaries 0..4 of mixed sizes under the plan: the victim is the
    # farthest reverse use whatever its size
    return ([("plan", 5, 1, 1)]
            + [("put", k, k, SIZES[k % 3]) for k in range(5)]
            + [("get", k) for k in (4, 3, 2, 1, 0)])


TIERED_CASES = {
    "capacity_respected": (2 * _NB, [("put", k, k, (4, 4)) for k in range(5)]
                           + [("get", k) for k in range(5)]
                           + [("delete", 0), ("get", 0)]),
    "eviction_order_plan_aware": (2 * _NB, [("plan", 5, 1, 1)]
                                  + [("put", k, k, (4, 4))
                                     for k in range(5)]),
    "demand_promotion": (2 * _NB, [("plan", 4, 1, 1)]
                         + [("put", k, k, (4, 4)) for k in range(4)]
                         + [("get", 3), ("delete", 3), ("get", 2),
                            ("delete", 2), ("get", 1), ("get", 0)]),
    "oversized_bypass": (_NB // 2, [("put", "big", 7, (4, 4)),
                                    ("get", "big"), ("delete", "big"),
                                    ("get", "big")]),
    "belady_mixed_sizes": (3 * _NB, _belady_mixed()),
    "peek_does_not_promote": (_NB, [("put", 0, 1, (4, 4)),
                                    ("put", 1, 2, (4, 4)), ("peek", 0),
                                    ("peek", 1), ("get", 0)]),
    "untracked_keys": (4 * _NB, [("put", "probe", 1, (4, 4)),
                                 ("put", 0, 2, (4, 4)), ("plan", 2, 1, 1),
                                 ("put", 1, 3, (4, 4))]),
}


@pytest.mark.parametrize("case", sorted(TIERED_CASES))
def test_tiered_unit_cases_match_jax(case):
    capacity, script = TIERED_CASES[case]
    ours, ref = _pair(capacity)
    _run_script(ours, ref, script)
    if case == "capacity_respected":
        # 3 spills from the puts, then FIFO promotions spill dirty residents
        assert ours.evictions == 5 and 0 not in ours
        assert ours.fast_peak_bytes == 2 * _NB
    elif case == "eviction_order_plan_aware":
        assert sorted(ours._fast) == [3, 4] and ours.evictions == 3
    elif case == "demand_promotion":
        assert ours.fast_hits == 2 and ours.promotions == 2
    elif case == "oversized_bypass":
        assert ours.fast_peak_bytes == 0 and "big" not in ours
    elif case == "peek_does_not_promote":
        assert ours.promotions == 1 and ours.slow_hits == 2
    elif case == "untracked_keys":
        assert ours.untracked_keys == 1


def test_tiered_compressed_slow_tier_matches_jax():
    big = {"x": np.random.default_rng(5).standard_normal(
        (64, 64)).astype(np.float32)}
    ours, ref = _pair(tree_bytes(big), compress=True)
    for ts in (ours, ref):
        ts.put(0, big)
        ts.put(1, big)             # evicts 0 through the int8 slow tier
    got, jgot = ours.get(0)["x"], np.asarray(ref.get(0)["x"])
    assert got.tobytes() == jgot.tobytes()
    assert float(np.max(np.abs(got - big["x"]))) <= \
        comp.quantization_error_bound(big["x"])
    # the slow tier's bytes hold the pickled structure, which differs by
    # framework
    _assert_tiers_equal(ours, ref, ("evictions", "promotions", "fast_hits",
                                    "slow_hits", "fast_peak_bytes"))


def test_tiered_host_tree_handover_spills_and_promotes(tmp_path):
    """The fused runner's hand-over through a tiered disk store: the fast
    tier keeps the frozen views by reference, an eviction pickles them, and
    a promotion comes back as a fresh array, equal bit for bit."""
    state = 8 * 8 * 4 + 8 * 8 * 2
    ts = TieredStorage(capacity_bytes=2 * state, directory=str(tmp_path))
    eng = AsyncTransferEngine(ts, device="cpu")
    plan = ms.segment_plan(4, 1, 1)
    ts.set_plan(plan)
    bufs = [(torch.full((8, 8), float(k)),
             torch.full((8, 8), float(k)).to(torch.bfloat16))
            for k in range(4)]
    for k, b in enumerate(bufs):
        eng.store_async(k, HostTree(b))
    eng.wait_stores()
    assert sorted(ts._fast) == [2, 3] and ts.evictions == 2
    assert np.shares_memory(ts._fast[3][0], bufs[3][0].numpy())
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0.pkl", "ckpt_1.pkl"]
    for k in (3, 2, 1, 0):
        eng.prefetch_async(k)
        got = eng.wait_prefetch(k)
        assert torch.equal(got[0], bufs[k][0])
        assert torch.equal(got[1], bufs[k][1])
        eng.delete(k)
    assert ts.promotions == 2 and ts.live_bytes == 0
    assert os.listdir(tmp_path) == []
    eng.close()


# -- the reference's write-behind races (test_storage_backends.py:479, :608)


def test_tiered_delete_during_writeback_leaves_nothing():
    gate = threading.Event()

    class GatedSlow(RAMStorage):
        def put(self, key, tree):
            gate.wait(5.0)
            super().put(key, tree)

    ts = TieredStorage(capacity_bytes=_NB, slow=GatedSlow())
    ts.put(0, _state(0))
    t = threading.Thread(target=lambda: ts.put(1, _state(1)))  # evicts 0
    t.start()
    deadline = time.monotonic() + 5.0
    while 0 not in ts._writing and time.monotonic() < deadline:
        time.sleep(0.01)
    ts.delete(0)               # racing the writeback
    gate.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert 0 not in ts and 0 not in ts.slow


def test_tiered_reevict_during_writeback_keeps_newest():
    gate = threading.Event()

    class GatedSlow(RAMStorage):
        def put(self, key, tree):
            if key == "A" and not gate.is_set():
                gate.wait(5.0)
            super().put(key, tree)

    ts = TieredStorage(capacity_bytes=_NB, slow=GatedSlow())
    ts.put("A", _state(1))
    done = threading.Event()

    def evict_a():
        ts.put("B", _state(0))   # evicts A; its writeback blocks on the gate
        done.set()

    t = threading.Thread(target=evict_a)
    t.start()
    deadline = time.monotonic() + 5.0
    while "A" not in ts._wb_active and time.monotonic() < deadline:
        time.sleep(0.01)
    ts.delete("A")               # tombstones the in-flight writeback
    ts.put("A", _state(2))       # revokes the tombstone
    ts.put("C", _state(0))       # evicts A again: new payload, same drainer
    gate.set()
    assert done.wait(5.0)
    t.join(timeout=5.0)
    assert not t.is_alive()
    np.testing.assert_array_equal(ts.get("A")["a"], _state(2)["a"])
    np.testing.assert_array_equal(ts.slow.get("A")["a"], _state(2)["a"])


# ---------------------------------------------------------------------------
# tenant quotas and namespaces (tests/test_serve.py:114-200)
# ---------------------------------------------------------------------------


def _bytes(nbytes):
    return {"x": np.zeros(nbytes // 4, np.float32)}


def test_quota_evicts_own_keys_only():
    tier = TieredStorage(capacity_bytes=100_000)
    tier.set_quota("a", 1_000)
    tier.set_quota("b", 1_000)
    tier.register_namespace("run_a", "a")
    tier.register_namespace("run_b", "b")
    va = NamespacedStorage(tier, "run_a")
    vb = NamespacedStorage(tier, "run_b")
    for i in range(2):
        vb.put(i, _bytes(400))
    for i in range(4):              # 1600B > tenant a's 1000B quota
        va.put(i, _bytes(400))
    assert tier.tenant_fast_bytes["a"] <= 1_000
    assert tier.tenant_fast_bytes["b"] == 800
    assert tier.tenant_fast_peak["a"] <= 1_000
    for i in range(4):
        assert np.asarray(va.get(i)["x"]).nbytes == 400
    assert sorted(va.keys()) == [0, 1, 2, 3]


def test_namespace_cap_bounds_measured_peak():
    tier = TieredStorage(capacity_bytes=100_000)
    tier.set_quota("a", 10_000)
    tier.register_namespace("job", "a", max_fast_bytes=900)
    v = NamespacedStorage(tier, "job")
    for i in range(8):
        v.put(i, _bytes(400))
    assert tier.ns_fast_peak["job"] <= 900
    assert v.fast_peak_bytes <= 900
    for i in range(8):
        assert np.asarray(v.get(i)["x"]).nbytes == 400
    assert tier.ns_fast_peak["job"] <= 900


def test_namespace_cap_bypass_oversized_state():
    tier = TieredStorage(capacity_bytes=100_000)
    tier.set_quota("a", 10_000)
    tier.register_namespace("job", "a", max_fast_bytes=100)
    v = NamespacedStorage(tier, "job")
    v.put(0, _bytes(400))
    assert tier.ns_fast_peak["job"] == 0
    assert np.asarray(v.get(0)["x"]).nbytes == 400


def test_demote_namespace_releases_quota():
    tier = TieredStorage(capacity_bytes=100_000)
    tier.set_quota("a", 10_000)
    tier.register_namespace("sess", "a")
    v = NamespacedStorage(tier, "sess")
    v.put("parked", _bytes(4_000))
    assert tier.tenant_fast_bytes["a"] == 4_000
    assert v.demote() == 1
    assert tier.tenant_fast_bytes["a"] == 0
    assert np.asarray(v.get("parked")["x"]).nbytes == 4_000


def test_namespaced_close_is_noop_and_drop_releases():
    tier = TieredStorage(capacity_bytes=1_000)
    tier.set_quota("a", 1_000)
    tier.register_namespace("r", "a")
    v = NamespacedStorage(tier, "r")
    v.put(0, _bytes(100))
    v.close()
    assert 0 in v
    assert v.drop() == 1 and 0 not in v and tier.live_bytes == 0


def test_register_namespace_unknown_tenant():
    tier = TieredStorage(capacity_bytes=1_000)
    with pytest.raises(KeyError):
        tier.register_namespace("r", "nobody")


def test_namespaced_plans_merge_into_the_shared_order():
    """Two runs' plans share one Belady order (update_plan): each keeps its
    own keys plan-aware, and the prefetch distance is the tier plan's."""
    tier = TieredStorage(capacity_bytes=4 * _NB)
    va, vb = NamespacedStorage(tier, "a"), NamespacedStorage(tier, "b")
    pa, pb = ms.segment_plan(4, 1, 1), ms.segment_plan(4, 1, 1)
    va.set_plan(pa)
    vb.set_plan(pb)
    for k in range(4):
        va.put(k, _state(k))
        vb.put(k, _state(10 + k))
    assert sorted(tier._fast) == [("a", 2), ("a", 3), ("b", 2), ("b", 3)]
    assert va.plan_prefetch_distance(pa) == \
        pa.tier_plan(4 * _NB, _NB).prefetch_distance
    np.testing.assert_array_equal(vb.get(0)["a"], _state(10)["a"])


# ---------------------------------------------------------------------------
# journaled storage (tests/test_storage_backends.py:645-800), each unit also
# run on the JAX package's store with the same calls
# ---------------------------------------------------------------------------


def _jtree(i=0):
    return {"a": np.arange(8, dtype=np.float32) + i,
            "b": np.ones((3,), np.float32) * i}


BOTH = {"port": make_backend, "ref": j_storage.make_backend}


def test_journaled_roundtrip_and_delegation(tmp_path):
    js = make_backend("ram", journal=str(tmp_path / "wal"))
    assert isinstance(js, JournaledStorage)
    js.put(0, _jtree(0))
    js.put(1, _jtree(1))
    np.testing.assert_array_equal(js.get(1)["a"], _jtree(1)["a"])
    assert 0 in js and set(js.keys()) == {0, 1}
    js.delete(0)
    assert 0 not in js
    # instrumentation delegates to the inner backend
    assert js.bytes_written > 0 and js.live_bytes > 0
    js.close()


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_journal_survives_process_death(tmp_path, pkg):
    """A RAM inner store evaporates with the process; a fresh
    JournaledStorage over the same directory — of either package —
    re-hydrates every store from the WAL, bit for bit."""
    jd = str(tmp_path / "wal")
    js = BOTH[pkg]("ram", journal=jd)
    js.begin_run({"n": 8})
    js.put(0, _jtree(0))
    js.put(4, _jtree(4))
    js.delete(0)
    js.close()                      # "crash": inner RAM is gone
    for reopen in (make_backend, j_storage.make_backend):
        js2 = reopen("ram", journal=jd)
        rec = js2.recover()
        assert rec.keys == (4,) and rec.meta == {"n": 8}
        np.testing.assert_array_equal(js2.get(4)["a"], _jtree(4)["a"])
        js2.close()


def test_journal_torn_tail_truncated_on_open(tmp_path):
    jd = str(tmp_path / "wal")
    js = make_backend("ram", journal=jd)
    js.put(0, _jtree(0))
    js.put(4, _jtree(4))
    js.close()
    path = os.path.join(jd, "wal.log")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:       # crash mid-write of the last record
        f.truncate(size - 7)
    js2 = make_backend("ram", journal=jd)
    rec = js2.recover()
    assert rec.torn and rec.keys == (0,)   # the torn record is discarded
    np.testing.assert_array_equal(js2.get(0)["a"], _jtree(0)["a"])
    js2.close()


def test_journal_checksum_flip_raises_then_repairs(tmp_path):
    jd = str(tmp_path / "wal")
    js = make_backend("ram", journal=jd)
    js.put(0, _jtree(0))
    js.put(4, _jtree(4))
    js.close()
    path = os.path.join(jd, "wal.log")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:       # bit rot inside the *last* record
        f.seek(size - 3)
        b = f.read(1)
        f.seek(size - 3)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ChecksumError, match="CRC"):
        make_backend("ram", journal=jd)
    js2 = make_backend("ram", journal=jd, journal_repair=True)
    rec = js2.recover()
    assert rec.keys == (0,)            # truncated back to the last good one
    js2.close()


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_journal_epoch_reset_bounds_growth(tmp_path, pkg):
    """begin_run truncates the file after a cleanly ended epoch, so a
    training loop's journal stays one gradient run long — the same sizes
    in both packages."""
    sizes = {}
    for name, make in BOTH.items():
        js = make("ram", journal=str(tmp_path / name))
        sizes[name] = []
        for step in range(3):
            js.begin_run({"step": step})
            js.put(0, _jtree(step))
            js.delete(0)
            js.end_run()
            sizes[name].append(js.journal_bytes)
        js.close()
    assert max(sizes[pkg]) <= sizes[pkg][0]   # no unbounded growth
    assert sizes["port"] == sizes["ref"]


def test_journal_over_compressed_is_read_consistent(tmp_path):
    """make_backend('compressed', journal=...) journals the *raw* payloads
    (journal outside the codec): get_exact returns the exact pre-crash
    state for resume replay, while a re-hydrated normal get round-trips
    through the codec and reproduces exactly the lossy values the
    fault-free run read back (bit-equal to the JAX package's codec)."""
    jd = str(tmp_path / "wal")
    js = make_backend("compressed", journal=jd, min_bytes=1)
    assert isinstance(js, JournaledStorage)
    assert isinstance(js.inner, CompressedStorage)
    big = {"w": np.linspace(-1.0, 1.0, 256).astype(np.float32)}
    js.put(0, big)
    lossy = np.asarray(js.get(0)["w"])       # int8 round-trip
    assert not np.array_equal(lossy, big["w"])   # quantization engaged
    js.close()
    js2 = make_backend("compressed", journal=jd, min_bytes=1)
    assert 0 in js2
    # exact raw record for resume replay...
    np.testing.assert_array_equal(np.asarray(js2.get_exact(0)["w"]),
                                  big["w"])
    # ...and codec-consistent values for reverse-sweep reads
    np.testing.assert_array_equal(np.asarray(js2.get(0)["w"]), lossy)
    js2.close()
    ref = j_storage.make_backend("compressed", journal=jd, min_bytes=1)
    np.testing.assert_array_equal(np.asarray(ref.get(0)["w"]), lossy)
    ref.close()


def test_compressed_treedef_survives_fresh_codec(tmp_path):
    """A hand-built CompressedStorage(inner=JournaledStorage(...)) can
    unflatten re-hydrated checkpoints in a fresh process (the pickled
    structure rides each payload), and the journal verbs pass through the
    codec to the journaled inner store."""
    jd = str(tmp_path / "wal")
    comp = CompressedStorage(inner=JournaledStorage(RAMStorage(), jd),
                             min_bytes=1)
    comp.begin_run({"n": 4})           # delegated to the inner journal
    big = {"w": np.linspace(-1.0, 1.0, 256).astype(np.float32)}
    comp.put(0, big)
    first = np.asarray(comp.get(0)["w"])
    assert comp.recover().keys == (0,)
    comp.inner.close()
    comp2 = CompressedStorage(inner=JournaledStorage(RAMStorage(), jd),
                              min_bytes=1)
    np.testing.assert_array_equal(np.asarray(comp2.get(0)["w"]), first)
    assert comp2.recover().meta == {"n": 4}
    comp2.inner.close()


def test_journaled_tiered_recovers(tmp_path):
    js = make_backend("tiered", journal=str(tmp_path / "wal"),
                      directory=str(tmp_path / "slow"), capacity_bytes=64)
    js.put(0, _jtree(0))
    js.put(4, _jtree(4))
    js.close()
    js2 = make_backend("tiered", journal=str(tmp_path / "wal"),
                       directory=str(tmp_path / "slow2"), capacity_bytes=64)
    np.testing.assert_array_equal(js2.get(0)["a"], _jtree(0)["a"])
    # plan-aware verbs pass through the journal to the tier
    assert js2.capacity_bytes == 64 and callable(js2.set_plan)
    js2.close()


# ---------------------------------------------------------------------------
# end to end: lstm-paper SMOKE through both front doors
# ---------------------------------------------------------------------------

INTERVAL, SLOTS = 8, 4
E2E_COUNTERS = ("l2_stores", "l2_fast_peak_bytes", "l2_evictions",
                "l2_promotions", "prefetch_depth")


def _smoke_inputs():
    cfg = j_get_config("lstm-paper", smoke=True)
    jparams = j_get_model(cfg).init(jax.random.PRNGKey(0))
    batch = j_make_batch(cfg, j_base.SMOKE_SHAPE, seed=0)
    ref = {k: np.asarray(v) for k, v in jparams.items()}
    return ref, np.array(batch["tokens"])


def _state_bytes():
    cfg = get_config("lstm-paper", smoke=True)
    B = j_base.SMOKE_SHAPE.global_batch
    return 2 * B * cfg.d_ff * 4 + 4      # (h, c, acc)


def _storage_kw(storage, budget):
    if storage != "tiered":
        return {"storage": storage}
    return {"storage": "tiered",
            "l2_capacity_bytes": budget * _state_bytes()}


_JAX_RUNS = {}


def _jax_run(storage, budget):
    key = (storage, budget)
    if key not in _JAX_RUNS:
        ref, tok = _smoke_inputs()
        vg = j_api.value_and_grad_offloaded(
            j_get_model(j_get_config("lstm-paper", smoke=True)).train_loss,
            interval=INTERVAL, slots=SLOTS, runner="compiled",
            **_storage_kw(storage, budget))
        loss, grads = vg({k: jnp.asarray(v) for k, v in ref.items()},
                         {"tokens": jnp.asarray(tok)})
        _JAX_RUNS[key] = (float(loss),
                          {k: np.asarray(g) for k, g in grads.items()},
                          j_api.last_plan().plan_id, j_api.last_stats())
    return _JAX_RUNS[key]


def _dense(ref, tok):
    p = params_from_numpy(ref, device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = lstm.forward_loss(leaves, torch.as_tensor(tok))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.numpy()
                                  for k, g in zip(leaves, grads)}


# budgets in boundary states: all four, half, one
E2E_CASES = [("disk", None), ("tiered", 4), ("tiered", 2), ("tiered", 1),
             ("compressed", None)]


@pytest.mark.parametrize("runner", ["compiled", "fused"])
@pytest.mark.parametrize("storage,budget", E2E_CASES)
def test_lstm_smoke_storage_kinds_match_jax(storage, budget, runner):
    ref, tok = _smoke_inputs()
    model = get_model(get_config("lstm-paper", smoke=True))
    vg = api.value_and_grad_offloaded(
        model.train_loss, interval=INTERVAL, slots=SLOTS, runner=runner,
        device="cpu", **_storage_kw(storage, budget))
    loss, grads = vg(params_from_numpy(ref, device="cpu"),
                     {"tokens": torch.as_tensor(tok)})
    stats, plan = api.last_stats(), api.last_plan()
    j_loss, j_grads, j_plan_id, j_stats = _jax_run(storage, budget)
    assert plan.plan_id == j_plan_id
    for name in E2E_COUNTERS:
        assert getattr(stats, name) == getattr(j_stats, name), name
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    grads = {k: g.numpy() for k, g in grads.items()}
    if storage == "compressed":
        # the reference's own bound (test_storage_backends.py:150), both
        # packages against dense autograd: quantised replay, not corruption
        d_loss, d_grads = _dense(ref, tok)
        np.testing.assert_allclose(float(loss), d_loss, rtol=1e-5)
        for g in (grads, j_grads):
            err = max(float(np.max(np.abs(g[k] - d_grads[k])))
                      for k in d_grads)
            assert 0.0 < err < 5e-2
        return
    for k, g in j_grads.items():
        np.testing.assert_allclose(grads[k], g, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=k)
    if storage == "tiered":
        state = _state_bytes()
        cap = budget * state
        n = j_base.SMOKE_SHAPE.seq_len
        tier = plan.tier_plan(cap, state)
        assert stats.l2_fast_peak_bytes == perfmodel.fast_peak_bytes_model(
            n, INTERVAL, state, cap) <= cap
        assert stats.l2_evictions == tier.spilled
        assert stats.prefetch_depth == tier.prefetch_distance


@pytest.mark.parametrize("budget", [1, 2, 4])
def test_lstm_smoke_journaled_tiered_matches_jax(budget, tmp_path):
    """A journal over the tiered store: the same Level-2 counters as the
    JAX package's (the journaled final state is one more key outside the
    plan, evicted once more), and bit for bit the unjournaled run."""
    ref, tok = _smoke_inputs()
    kw = {"interval": INTERVAL, "slots": SLOTS,
          **_storage_kw("tiered", budget)}
    j_api.value_and_grad_offloaded(
        j_get_model(j_get_config("lstm-paper", smoke=True)).train_loss,
        journal_dir=str(tmp_path / "j_wal"),
        storage_dir=str(tmp_path / "j_l2"), **kw)(
        {k: jnp.asarray(v) for k, v in ref.items()},
        {"tokens": jnp.asarray(tok)})
    j_stats = j_api.last_stats()
    model = get_model(get_config("lstm-paper", smoke=True))
    inputs = (params_from_numpy(ref, device="cpu"),
              {"tokens": torch.as_tensor(tok)})
    plain = api.value_and_grad_offloaded(model.train_loss, device="cpu",
                                         **kw)(*inputs)
    loss, grads = api.value_and_grad_offloaded(
        model.train_loss, device="cpu", journal_dir=str(tmp_path / "wal"),
        storage_dir=str(tmp_path / "l2"), **kw)(*inputs)
    stats, plan = api.last_stats(), api.last_plan()
    for name in E2E_COUNTERS:
        assert getattr(stats, name) == getattr(j_stats, name), name
    tier = plan.tier_plan(budget * _state_bytes(), _state_bytes())
    assert stats.l2_evictions == tier.spilled + 1
    assert stats.l2_promotions == tier.spilled
    assert torch.equal(loss, plain[0])
    for k, g in plain[1].items():
        assert torch.equal(grads[k], g), k


def test_disk_run_leaves_no_directory_behind(tmp_path, monkeypatch):
    ref, tok = _smoke_inputs()
    model = get_model(get_config("lstm-paper", smoke=True))
    d = tmp_path / "l2"
    vg = api.value_and_grad_offloaded(
        model.train_loss, interval=INTERVAL, slots=SLOTS, device="cpu",
        storage="disk", storage_dir=str(d))
    vg(params_from_numpy(ref, device="cpu"), {"tokens": torch.as_tensor(tok)})
    assert os.listdir(d) == []          # every boundary file deleted
    made = []
    real = tempfile.mkdtemp

    def spy(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(fe.tempfile, "mkdtemp", spy)
    api.value_and_grad_offloaded(
        model.train_loss, interval=INTERVAL, slots=SLOTS, device="cpu",
        storage="tiered", l2_capacity_bytes=_state_bytes())(
        params_from_numpy(ref, device="cpu"),
        {"tokens": torch.as_tensor(tok)})
    assert len(made) == 1 and not os.path.exists(made[0])


def test_shared_backend_through_the_front_door():
    """backend= takes the caller's store (a namespaced view of one shared
    tier): the run's keys are namespaced, its fast peak stays within the
    namespace's cap, and the store is not closed by the run."""
    ref, tok = _smoke_inputs()
    model = get_model(get_config("lstm-paper", smoke=True))
    state = _state_bytes()
    tier = TieredStorage(capacity_bytes=16 * state)
    tier.set_quota("t", 16 * state)
    tier.register_namespace("run", "t", max_fast_bytes=2 * state)
    view = NamespacedStorage(tier, "run")
    vg = api.value_and_grad_offloaded(
        model.train_loss, interval=INTERVAL, slots=SLOTS, device="cpu",
        backend=view)
    assert vg.backend is view
    loss, _ = vg(params_from_numpy(ref, device="cpu"),
                 {"tokens": torch.as_tensor(tok)})
    j_loss = _jax_run("ram", None)[0]
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    assert tier.ns_fast_peak["run"] == 2 * state
    assert api.last_stats().l2_evictions == 2
    assert tier.keys() == [] and tier.live_bytes == 0
    with pytest.raises(ValueError, match="backend="):
        api.value_and_grad_offloaded(model.train_loss, backend=view,
                                     storage="disk", device="cpu")


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------


def test_tiered_autotune_probes_the_slow_tier():
    """The tiered probe fills ``t_t_slow`` and ``capacity_bytes``, the
    cache key carries the budget (another budget measures again), and the
    interval obeys the reference's rule (test_storage_backends.py:598)."""
    ref, tok = _smoke_inputs()
    model = get_model(get_config("lstm-paper", smoke=True))
    state = _state_bytes()
    tuner = at.AutoTuner()
    params = params_from_numpy(ref, device="cpu")
    batch = {"tokens": torch.as_tensor(tok)}
    for cap in (2 * state, 3 * state):
        api.value_and_grad_offloaded(
            model.train_loss, storage="tiered", l2_capacity_bytes=cap,
            tuner=tuner, runner="fused", device="cpu")(params, batch)
        tune = api.last_tune()
        assert tune.source == "measured" and tune.probe_calls > 0
        assert tune.capacity_bytes == cap and tune.t_t_slow > 0.0
        n = j_base.SMOKE_SHAPE.seq_len
        if math.ceil(n / tune.interval) * state > cap:
            assert tune.interval * tune.t_a >= min(tune.t_t, tune.t_t_slow)
    levels = sorted(k[3] for k in tuner._cache)
    assert levels == [f"TieredStorage[{2 * state}]",
                      f"TieredStorage[{3 * state}]"]


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"storage": "tiered"},
    {"l2_capacity_bytes": 100},
    {"storage": "disk", "l2_capacity_bytes": 100},
    {"backend_id": 1, "mesh": "MESH"},
    # several faults: the first in the JAX package's order is named
    {"storage": "tiered", "runner": "PALLAS", "engine": "interpreted"},
    {"l2_capacity_bytes": 5, "backend_id": 1, "mesh": "MESH"},
    {"storage": "tiered", "engine": "scan"},
])
def test_storage_knobs_raise_the_same_value_errors_in_order(kw):
    from repro.api.frontend import OffloadConfig as JConfig

    j_kw = {k: ("pallas" if v == "PALLAS" else v) for k, v in kw.items()}
    t_kw = {k: ("fused" if v == "PALLAS" else v) for k, v in kw.items()}
    with pytest.raises(ValueError) as j_err:
        JConfig(**j_kw)
    with pytest.raises(ValueError) as t_err:
        fe.OffloadConfig(**t_kw)
    if "runner" in kw:
        assert "runner=" in str(j_err.value) and \
            "runner=" in str(t_err.value)
    else:
        assert str(t_err.value) == str(j_err.value)


def test_storage_kinds_are_accepted():
    for kw in ({"storage": "disk"}, {"storage": "compressed"},
               {"storage": "tiered", "l2_capacity_bytes": 1},
               {"storage": "disk", "storage_dir": "d"}):
        assert fe.OffloadConfig(**kw).storage == kw["storage"]
