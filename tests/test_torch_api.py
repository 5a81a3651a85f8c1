"""The port's ``value_and_grad_offloaded`` against the JAX package's, on the
CPU with a pinned schedule.

``runner="fused"`` (the port's plain versions of the fused kernels off the
card) is held against JAX's ``runner="pallas"`` in interpret mode, and
``runner="compiled"`` against JAX's compiled runner: the loss within 1e-5,
gradients within 1e-4 of each leaf's scale, and the plan and the executor
counters *equal*.  Segments and in-segment chunks have uneven tails, and
one case has a length-1 chunk tail.  The paper's baselines (Revolve,
store-all) and the interpreted engine are held the same way against JAX's
front door, and ``checkpointed_bptt`` against JAX's on a synthetic chain.
The ``T_T`` probe is shown to go through the engine's own store path.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.models import lstm as j_lstm
from repro_torch import api
from repro_torch.api import frontend as fe
from repro_torch.convert import init_lstm_numpy, params_from_numpy
from repro_torch.models import lstm

V, DX, DH, B = 17, 8, 12, 3
COUNTERS = ("advances", "backwards", "l2_stores", "host_dispatches",
            "fused_segments", "fused_boundary_copies", "l2_peak_bytes")


def _inputs(T, seed):
    ref = init_lstm_numpy(seed, V, DX, DH)
    tok = np.random.default_rng(seed).integers(0, V, (B, T + 1)).astype(
        np.int32)
    return ref, tok


def _jax_run(ref, tok, runner, interval, slots, monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    vg = j_api.value_and_grad_offloaded(
        j_lstm.train_chain(), interval=interval, slots=slots, runner=runner)
    loss, grads = vg({k: jnp.asarray(v) for k, v in ref.items()},
                     {"tokens": jnp.asarray(tok)})
    return (float(loss), jax.tree_util.tree_map(np.asarray, grads),
            j_api.last_plan().plan_id, j_api.last_stats())


def _port_run(ref, tok, runner, interval, slots):
    vg = api.value_and_grad_offloaded(
        lstm.train_chain(), interval=interval, slots=slots, runner=runner,
        device="cpu")
    loss, grads = vg(params_from_numpy(ref, device="cpu"),
                     {"tokens": torch.as_tensor(tok)})
    return (float(loss), {k: g.numpy() for k, g in grads.items()},
            api.last_plan().plan_id, api.last_stats())


def _assert_same(port, ref):
    loss, grads, plan_id, stats = port
    j_loss, j_grads, j_plan_id, j_stats = ref
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert set(grads) == set(j_grads)
    for k, g in j_grads.items():
        np.testing.assert_allclose(grads[k], g, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=k)
    assert plan_id == j_plan_id
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(j_stats, name), name


@pytest.mark.parametrize("T,interval,slots", [
    (37, 8, 4),     # uneven segment tail (5) + uneven chunk tails
    (24, 24, 5),    # single segment, chunked with a short tail
    (30, 13, 4),    # chunks 4,4,4,1: a length-1 tail
])
def test_fused_runner_matches_jax_pallas(T, interval, slots, monkeypatch):
    ref, tok = _inputs(T, seed=T)
    j = _jax_run(ref, tok, "pallas", interval, slots, monkeypatch)
    assert j[3].fused_segments > 0   # interpret-mode kernels really ran
    _assert_same(_port_run(ref, tok, "fused", interval, slots), j)


def test_compiled_runner_matches_jax_compiled(monkeypatch):
    ref, tok = _inputs(37, seed=3)
    j = _jax_run(ref, tok, "compiled", 8, 4, monkeypatch)
    _assert_same(_port_run(ref, tok, "compiled", 8, 4), j)


def test_runners_agree_with_dense_autograd():
    ref, tok = _inputs(29, seed=9)
    p = params_from_numpy(ref, device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = lstm.forward_loss(leaves, torch.as_tensor(tok))
    dense = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    for runner in ("compiled", "fused"):
        v, g = api.value_and_grad_offloaded(
            lstm.train_chain(), interval=7, slots=3, runner=runner,
            device="cpu")(p, {"tokens": torch.as_tensor(tok)})
        torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
        for k in dense:
            torch.testing.assert_close(
                g[k], dense[k], rtol=1e-4,
                atol=1e-4 * float(dense[k].abs().max()))


@pytest.mark.parametrize("kw", [
    {"strategy": "nope"},
    {"engine": "nope"},
    {"runner": "nope"},
    {"runner": "PALLAS", "engine": "interpreted"},
    {"runner": "PALLAS", "engine": "scan"},
    {"engine": "scan", "strategy": "revolve"},
    {"engine": "scan", "storage": "disk"},
])
def test_offload_config_raises_the_same_value_errors(kw):
    from repro.api.frontend import OffloadConfig as JConfig

    j_kw = {k: ("pallas" if v == "PALLAS" else v) for k, v in kw.items()}
    t_kw = {k: ("fused" if v == "PALLAS" else v) for k, v in kw.items()}
    with pytest.raises(ValueError) as j_err:
        JConfig(**j_kw)
    with pytest.raises(ValueError) as t_err:
        fe.OffloadConfig(**t_kw)
    # the same knob is named in both messages
    knob = next(iter(kw)) if kw.get("runner") != "PALLAS" else "runner"
    assert knob in str(j_err.value) and knob in str(t_err.value)


@pytest.mark.parametrize("kw,item", [
    # the ids the cases had while journal_dir=, engine="scan" and
    # offload_params= were left-out knobs too
    pytest.param({"mesh": "MESH"}, "item 15", id="kw2-item 15"),
    pytest.param({"step_memory_budget": 1 << 20}, "item 11",
                 id="kw3-item 11"),
    pytest.param({"plan_2d": (2, 1)}, "item 11", id="kw4-item 11"),
])
def test_left_out_knobs_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        fe.OffloadConfig(**kw)


@pytest.mark.parametrize("kw", [
    {"engine": "scan"},
    {"engine": "scan", "interval": 8, "slots": 2, "autotune": False},
    {"offload_params": "moe_experts"},
    {"offload_params": "moe_experts", "storage": "tiered",
     "l2_capacity_bytes": 1 << 20},
])
def test_scan_and_stream_knobs_are_accepted(kw):
    """``engine="scan"`` and ``offload_params=`` (left-out knobs until the
    scan engine and parameter streaming were ported) build a config as in
    the JAX package."""
    from repro.api.frontend import OffloadConfig as JConfig

    cfg = fe.OffloadConfig(**kw)
    j_cfg = JConfig(**kw)
    for k in kw:
        assert getattr(cfg, k) == getattr(j_cfg, k)


@pytest.mark.parametrize("kw", [
    {"journal_dir": "wal"},
    {"journal_dir": "wal", "resume": True, "journal_repair": True},
    {"journal_dir": "wal", "engine": "interpreted", "storage": "disk"},
])
def test_journal_knobs_are_accepted(kw):
    """``journal_dir=`` (a left-out knob until the journal was ported),
    ``resume=`` and ``journal_repair=`` build a config as in the JAX
    package."""
    from repro.api.frontend import OffloadConfig as JConfig

    cfg = fe.OffloadConfig(**kw)
    ref = JConfig(**kw)
    for k in kw:
        assert getattr(cfg, k) == getattr(ref, k) == kw[k]


def _strategy_runs(ref, tok, kw):
    j_vg = j_api.value_and_grad_offloaded(j_lstm.train_chain(), **kw)
    j_loss, j_grads = j_vg({k: jnp.asarray(v) for k, v in ref.items()},
                           {"tokens": jnp.asarray(tok)})
    j_plan = j_api.last_plan()
    j = (float(j_loss), jax.tree_util.tree_map(np.asarray, j_grads),
         None if j_plan is None else j_plan.plan_id, j_api.last_stats())
    vg = api.value_and_grad_offloaded(lstm.train_chain(), device="cpu",
                                      **kw)
    loss, grads = vg(params_from_numpy(ref, device="cpu"),
                     {"tokens": torch.as_tensor(tok)})
    plan = api.last_plan()
    t = (float(loss), {k: g.numpy() for k, g in grads.items()},
         None if plan is None else plan.plan_id, api.last_stats())
    return t, j


STRATEGY_COUNTERS = ("advances", "backwards", "host_dispatches",
                     "peak_l1_states", "recompute_factor", "l2_stores",
                     "l2_prefetches", "l2_peak_bytes")


@pytest.mark.parametrize("T,kw", [
    (29, {"strategy": "conventional"}),
    (29, {"strategy": "revolve", "slots": 6}),
    (37, {"strategy": "revolve", "slots": 3}),
    (29, {"engine": "interpreted", "interval": 8, "slots": 6}),
    (37, {"engine": "interpreted", "interval": 13, "slots": 4}),
])
def test_strategies_and_interpreted_engine_match_jax(T, kw):
    """Revolve (``s = slots``), store-all and the interpreted multistage
    engine through the front door: the loss within 1e-5 and gradients
    within 1e-4 of JAX's, the executor counters and the plan equal."""
    ref, tok = _inputs(T, seed=100 + T)
    (loss, grads, plan_id, stats), (j_loss, j_grads, j_plan_id, j_stats) = \
        _strategy_runs(ref, tok, kw)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    for k, g in j_grads.items():
        np.testing.assert_allclose(grads[k], g, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=k)
    assert plan_id == j_plan_id
    for name in STRATEGY_COUNTERS:
        assert getattr(stats, name) == getattr(j_stats, name), name
    assert api.last_tune().slots == j_api.last_tune().slots


def test_revolve_and_store_all_counters_follow_their_plans():
    """Revolve's advances are ``count_advances(revolve_schedule(n, s))``
    within ``s`` slots; store-all advances ``n`` times and keeps all ``n``
    states; the interpreted engine's advances are the plan's total."""
    from repro_torch.core import revolve as rv

    ref, tok = _inputs(41, seed=7)
    params = params_from_numpy(ref, device="cpu")
    batch = {"tokens": torch.as_tensor(tok)}
    n = 41
    for kw, advances, peak in (
            ({"strategy": "revolve", "slots": 5},
             rv.count_advances(rv.revolve_schedule(n, 5)), 5),
            ({"strategy": "conventional"}, n, n)):
        api.value_and_grad_offloaded(lstm.train_chain(), device="cpu",
                                     **kw)(params, batch)
        stats = api.last_stats()
        assert (stats.advances, stats.backwards, stats.peak_l1_states) == (
            advances, n, peak), kw
        assert api.last_plan() is None
    api.value_and_grad_offloaded(lstm.train_chain(), engine="interpreted",
                                 interval=10, slots=3, device="cpu")(params,
                                                                     batch)
    stats, plan = api.last_stats(), api.last_plan()
    assert stats.advances == plan.total_advances()
    assert stats.backwards == n and stats.peak_l1_states <= 3


@pytest.fixture(scope="module")
def rnn_chain():
    """The synthetic chain of the JAX package's ``checkpointed_bptt`` tests,
    inputs drawn with numpy."""
    T, Bn, D = 37, 4, 8
    rng = np.random.default_rng(0)
    params = {"W": (rng.standard_normal((D, D)) * 0.4).astype(np.float32),
              "U": (rng.standard_normal((D, D)) * 0.2).astype(np.float32)}
    xs = (rng.standard_normal((T, Bn, D)) * 0.1).astype(np.float32)
    return params, np.zeros((Bn, D), np.float32), xs


@pytest.mark.parametrize("kw", [
    {"strategy": "conventional"},
    {"strategy": "revolve", "slots": 6},
    {"strategy": "multistage_async", "interval": 8, "slots": 6},
    {"strategy": "multistage_async", "interval": 8, "slots": 6,
     "engine": "interpreted"},
])
def test_checkpointed_bptt_matches_jax(rnn_chain, kw):
    params, c0, xs = rnn_chain

    def j_body(p, c, x):
        c = jnp.tanh(c @ p["W"] + x @ p["U"])
        return c, jnp.sum(c ** 2)

    def t_body(p, c, x):
        c = torch.tanh(c @ p["W"] + x @ p["U"])
        return c, torch.sum(c ** 2)

    j_loss, j_grads = j_api.checkpointed_bptt(j_body, **kw)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(c0),
        jnp.asarray(xs))
    j_stats = j_api.last_stats()
    loss, grads = api.checkpointed_bptt(t_body, device="cpu", **kw)(
        {k: torch.as_tensor(v) for k, v in params.items()},
        torch.as_tensor(c0), torch.as_tensor(xs))
    stats = api.last_stats()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k in params:
        g = np.asarray(j_grads[k])
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)
    for name in STRATEGY_COUNTERS:
        assert getattr(stats, name) == getattr(j_stats, name), name


@pytest.mark.parametrize("engine,runner", [
    ("compiled", "compiled"), ("compiled", "fused"),
    ("interpreted", "compiled"),
])
def test_tt_probe_goes_through_the_engines_store_path(engine, runner,
                                                      monkeypatch):
    """``T_T`` is timed on the store the run makes: the engine's own
    snapshot (a CPU or device carry) or hand-over (the chunk entry a fused
    advance wrote), then the writer's put — each probe call goes through
    ``AsyncTransferEngine._payload`` and ``_put``, as every store of the run
    does."""
    from repro_torch.core import storage

    calls = {"payload": [], "put": [], "snapshot": 0}
    real = {n: getattr(storage.AsyncTransferEngine, n)
            for n in ("_payload", "_put", "_snapshot")}

    def payload(self, tree):
        out = real["_payload"](self, tree)
        calls["payload"].append(type(out).__name__)
        return out

    def put(self, key, payload_):
        calls["put"].append(key)
        return real["_put"](self, key, payload_)

    def snapshot(self, tree):
        calls["snapshot"] += 1
        return real["_snapshot"](self, tree)

    monkeypatch.setattr(storage.AsyncTransferEngine, "_payload", payload)
    monkeypatch.setattr(storage.AsyncTransferEngine, "_put", put)
    monkeypatch.setattr(storage.AsyncTransferEngine, "_snapshot", snapshot)
    ref, tok = _inputs(40, seed=5)
    tuner = api.AutoTuner()
    api.value_and_grad_offloaded(
        lstm.train_chain(), engine=engine, runner=runner, tuner=tuner,
        device="cpu")(params_from_numpy(ref, device="cpu"),
                      {"tokens": torch.as_tensor(tok)})
    tune, stats = api.last_tune(), api.last_stats()
    probes = 1 + tuner.repeats
    assert tune.source == "measured" and tune.t_t > 0
    probe_puts = [k for k in calls["put"]
                  if isinstance(k, tuple) and k[0] == "__autotune__"]
    assert len(probe_puts) == probes
    assert len(calls["put"]) == probes + stats.l2_stores
    assert len(calls["payload"]) == probes + stats.l2_stores
    if runner == "fused":
        # the kernel's own buffers are handed over: no snapshot at all
        assert calls["snapshot"] == 0
        assert set(calls["payload"]) == {"HostTree"}
    else:
        assert calls["snapshot"] == probes + stats.l2_stores


def test_autotuned_interval_follows_section_3():
    """I == snap_interval(n, ceil(T_T / T_A)) from the run's own
    measurements."""
    ref, tok = _inputs(40, seed=4)
    tuner = api.AutoTuner()
    vg = api.value_and_grad_offloaded(lstm.train_chain(), runner="fused",
                                      tuner=tuner, device="cpu")
    vg(params_from_numpy(ref, device="cpu"),
       {"tokens": torch.as_tensor(tok)})
    tune = api.last_tune()
    assert tune.source == "measured" and tune.t_a > 0 and tune.t_t > 0
    n = api.last_plan().n
    assert tune.interval == api.snap_interval(
        n, max(1, math.ceil(tune.t_t / tune.t_a)))
    assert api.last_plan().interval == tune.interval
    # the probe's fused advances are recorded; a cached schedule runs none
    assert tune.probe_calls == 1 + tuner.repeats and tune.probe_len > 0
    vg(params_from_numpy(ref, device="cpu"),
       {"tokens": torch.as_tensor(tok)})
    assert api.last_tune().probe_calls == 0
    assert api.last_tune().interval == tune.interval


def test_plain_loss_falls_back_with_warning():
    def loss_fn(p, b):
        return (p["w"] * b["x"]).sum()

    with pytest.warns(UserWarning, match="no chain decomposition"):
        vg = api.value_and_grad_offloaded(loss_fn, device="cpu")
    v, g = vg({"w": torch.tensor(2.0)}, {"x": torch.arange(3.0)})
    assert float(v) == 6.0 and float(g["w"]) == 3.0


def test_run_multistage_single_shot_matches_the_front_end():
    """The executor's single-shot form (forward sweep, adjoint seeded from
    x_n by a hook, reverse sweep) gives the front-end's gradients."""
    from repro_torch.api.chain import diff_mask
    from repro_torch.core.compiled_ops import (CompiledChainOps,
                                               FusedSegmentRunner)
    from repro_torch.core.executor import CheckpointExecutor

    ref, tok = _inputs(26, seed=11)
    params = params_from_numpy(ref, device="cpu")
    batch = {"tokens": torch.as_tensor(tok)}
    spec = lstm.train_chain()
    carry0, xs = spec.prelude(params, batch)
    treespec, mask = diff_mask(xs)
    runner = FusedSegmentRunner(CompiledChainOps(spec.body, treespec, mask),
                                params, xs, batch, s_l1=3)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}

    def seed(x_n):   # d loss / d carry_n for loss = acc
        h, c, acc = x_n
        return ((torch.zeros_like(h), torch.zeros_like(c),
                 torch.ones_like(acc)), zeros)

    (dcarry0, grads), stats = CheckpointExecutor().run_multistage(
        carry0, len(tok[0]) - 1, None, interval=7, s_l1=3, runner=runner,
        final_hook=seed)
    _, ref_grads = api.value_and_grad_offloaded(
        spec, interval=7, slots=3, runner="fused", device="cpu")(params,
                                                                 batch)
    assert stats.l2_stores == 4 and stats.fused_segments == 8
    for k in ref_grads:
        torch.testing.assert_close(grads[k], ref_grads[k], rtol=1e-6,
                                   atol=0)


def test_gradient_accumulator_holds_memory_only_for_read_params():
    """The reverse sweep's parameter accumulator starts as broadcast zeros:
    a leaf takes a copy of its first real gradient and is added to in
    place after, and a parameter the steps never read (a depth chain's
    stacked layers, read from ``xs``) never gets a buffer."""
    from repro_torch.api.chain import accumulate, is_broadcast_zero

    params = {"read": torch.ones(3, 4), "unread": torch.ones(1000),
              "scalar": torch.ones(())}
    gacc = fe._Ops.zero_grads(params)
    assert is_broadcast_zero(gacc["read"])
    assert gacc["unread"].untyped_storage().nbytes() == 4
    dp = {"read": torch.full((3, 4), 2.0),
          "unread": torch.zeros(()).expand(1000),
          "scalar": torch.tensor(0.5)}
    gacc = accumulate(gacc, dp)
    assert torch.equal(gacc["read"], dp["read"])
    assert gacc["read"].data_ptr() != dp["read"].data_ptr()
    assert is_broadcast_zero(gacc["unread"])
    first = gacc["read"]
    gacc = accumulate(gacc, dp)
    assert gacc["read"] is first and float(first[0, 0]) == 4.0
    assert float(gacc["scalar"]) == 1.0
