"""The port's scan engine (``engine="scan"``, ``core/multistage_scan.py``)
against the JAX package's, on the CPU (a port of
``tests/test_engine_parity.py``'s cases that need no ``jax.jit``,
``jax.vmap`` or mesh).

* One plan drives the port's three engines — compiled, interpreted and
  scan — with the same boundaries, segment lengths and store events as the
  JAX package's ``segment_plan`` for a chain whose length the interval
  does not divide (an uneven tail), and each engine's gradient is within
  1e-4 (``max_rel_err``) of ``jax.value_and_grad`` over a ``lax.scan`` and
  of the other two.
* ``_plan_groups`` equals the reference's for several ``(n, I, s)``, one
  with inner chunks.
* ``multistage_scan`` (plan, interval, nested intervals) and
  ``models.lstm.bptt_loss_and_grad`` on ``lstm-paper`` SMOKE weights
  against the reference's at 1e-4, and the front door's scan engine on the
  LSTM and on a decoder (``gemma2-2b`` SMOKE, whose stacked layers are the
  chain's inputs) against dense autograd and the JAX package's scan engine.
* Each scan call offloads one boundary a segment (``api.last_scan()``:
  host-to-host copies here), ``last_stats()`` is ``None`` after it, and the
  roofline ``T_T`` the CPU tuning uses equals the reference's.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import api as j_api
from repro.core import schedule as j_sched
from repro.models import lstm as j_lstm
from repro_torch import api
from repro_torch.convert import params_from_numpy
from repro_torch.core import multistage_scan as ms
from repro_torch.core import schedule as sched
from repro_torch.models import lstm

from _helpers import max_rel_err as _max_err  # noqa: E402

# the module (``repro.core`` exports its function under the same name)
j_ms = importlib.import_module("repro.core.multistage_scan")

T, B, D = 41, 4, 8        # 41 = 5 x 8 + 1: n % I != 0
INTERVAL, SLOTS = 8, 4
ALL_ENGINES = ("compiled", "interpreted", "scan")


@pytest.fixture(scope="module")
def chain():
    rng = np.random.default_rng(0)
    params = {"W": (rng.standard_normal((D, D)) * 0.4).astype(np.float32),
              "U": (rng.standard_normal((D, D)) * 0.2).astype(np.float32)}
    xs = (rng.standard_normal((T, B, D)) * 0.1).astype(np.float32)
    c0 = np.zeros((B, D), np.float32)

    def j_body(p, c, x):
        c = jnp.tanh(c @ p["W"] + x @ p["U"])
        return c, jnp.sum(c ** 2)

    def ref_loss(p, c0_, xs_):
        _, ls = jax.lax.scan(lambda c, x: j_body(p, c, x), c0_, xs_)
        return jnp.sum(ls)

    ref_v, ref_g = jax.value_and_grad(ref_loss)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(c0),
        jnp.asarray(xs))
    return params, c0, xs, j_body, float(ref_v), ref_g


def _body(p, c, x):
    c = torch.tanh(c @ p["W"] + x @ p["U"])
    return c, (c ** 2).sum()


def _torch(tree):
    return pytree.tree_map(torch.as_tensor, tree)


def _np(tree):
    return pytree.tree_map(lambda t: t.detach().numpy(), tree)


def _bptt(engine, **opts):
    return api.checkpointed_bptt(
        _body, strategy="multistage_async", interval=INTERVAL, slots=SLOTS,
        engine=engine, device="cpu", **opts)


def test_one_plan_drives_all_engines(chain):
    """Same (n, I, s) -> every engine of the port reports the reference's
    SegmentPlan: same boundaries, segment lengths and store events, the
    uneven tail included; the executor engines store once a boundary and
    the scan engine offloads once a segment."""
    params, c0, xs, _, ref_v, ref_g = chain
    ref_plan = j_sched.segment_plan(T, INTERVAL, SLOTS)
    assert ref_plan.segments[-1].length == 1          # uneven tail exists
    plans = {}
    for engine in ALL_ENGINES:
        v, g = _bptt(engine)(_torch(params), torch.as_tensor(c0),
                             torch.as_tensor(xs))
        assert abs(float(v) - ref_v) < 1e-4, engine
        assert _max_err(_np(g), ref_g) < 1e-4, engine
        plan = api.last_plan()
        assert plan is not None, engine
        plans[engine] = plan
        if engine != "scan":
            assert api.last_stats().l2_stores == plan.num_segments
        else:
            assert api.last_stats() is None
            rec = api.last_scan()
            assert rec.segments == plan.num_segments
            assert rec.boundaries_offloaded == plan.num_segments
            assert rec.prefetches + rec.demand_loads == plan.num_segments
            assert rec.d2h_bytes == rec.h2d_bytes == \
                plan.num_segments * (B * D * 4 + 4)
    for engine, plan in plans.items():
        assert plan.n == ref_plan.n, engine
        assert plan.boundaries() == ref_plan.boundaries(), engine
        assert plan.store_events() == ref_plan.store_events(), engine
        assert [s.length for s in plan.segments] == \
            [s.length for s in ref_plan.segments], engine
        assert [s.revolve is not None for s in plan.segments] == \
            [s.revolve is not None for s in ref_plan.segments], engine
        assert plan.plan_id == ref_plan.plan_id, engine


def test_engines_agree_pairwise(chain):
    """The three engines' gradients agree with each other (not just with
    the reference): interchangeable executors over one plan."""
    params, c0, xs, _, _, _ = chain
    grads = {e: _np(_bptt(e)(_torch(params), torch.as_tensor(c0),
                             torch.as_tensor(xs))[1])
             for e in ALL_ENGINES}
    for a in ALL_ENGINES:
        for b in ALL_ENGINES:
            assert _max_err(grads[a], grads[b]) < 1e-4, (a, b)


def test_scan_engine_config_validation():
    with pytest.raises(ValueError, match="multistage_async"):
        api.OffloadConfig(engine="scan", strategy="revolve")
    with pytest.raises(ValueError, match="host memory"):
        api.OffloadConfig(engine="scan", storage="disk")
    with pytest.raises(ValueError, match="cannot be journaled"):
        api.OffloadConfig(engine="scan", journal_dir="wal")


@pytest.mark.parametrize("n,interval,s_l1", [
    (41, 8, 4), (64, 16, 4), (100, 7, 3), (12, 12, 16), (9, 4, 1),
    (1000, 64, 16), (5, 1, 2)])
def test_plan_groups_equal_the_reference(n, interval, s_l1):
    plan = sched.segment_plan(n, interval, s_l1)
    j_plan = j_sched.segment_plan(n, interval, s_l1)
    groups = ms._plan_groups(plan)
    assert groups == j_ms._plan_groups(j_plan)
    if (n, interval, s_l1) == (41, 8, 4):
        assert all(nested for _, _, nested in groups[:-1])  # inner chunks


@pytest.mark.parametrize("kw", [
    {"interval": 8}, {"interval": 8, "s_l1": 4},
    {"interval": 8, "nested_intervals": (3,)},
    {"interval": 16, "nested_intervals": (5, 2)}, {"interval": 41}],
    ids=["interval", "s_l1", "nested", "nested2", "one-segment"])
def test_multistage_scan_matches_the_reference(chain, kw):
    """``multistage_scan`` itself (ys stacked per step) against the JAX
    package's on the same chain: the final carry, the per-step losses and
    the gradients of the parameters, the initial carry and the inputs."""
    params, c0, xs, j_body, _, _ = chain

    def j_total(p, c, x):
        cn, ls = j_ms.multistage_scan(lambda c_, x_: j_body(p, c_, x_),
                                      c, x, **kw)
        return jnp.sum(ls) + jnp.sum(cn)

    j_v, j_g = jax.value_and_grad(j_total, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(c0),
        jnp.asarray(xs))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    c = torch.tensor(c0, requires_grad=True)
    x = torch.tensor(xs, requires_grad=True)
    cn, ls = ms.multistage_scan(_body, c, x, params=p, **kw)
    assert ls.shape == (T,)
    total = ls.sum() + cn.sum()
    g = torch.autograd.grad(total, [p["W"], p["U"], c, x])
    np.testing.assert_allclose(float(total), float(j_v), rtol=1e-5)
    assert _max_err([t.numpy() for t in g],
                    [j_g[0]["W"], j_g[0]["U"], j_g[1], j_g[2]]) < 1e-4
    rec = api.last_scan()
    assert rec.boundaries_offloaded == rec.segments == \
        -(-T // kw["interval"])


@pytest.fixture(scope="module")
def lstm_smoke():
    from repro.configs import base as j_base
    from repro.configs.registry import get_config as j_get_config
    from repro.configs.shapes import make_batch as j_make_batch
    from repro.models.model_factory import get_model as j_get_model

    cfg = j_get_config("lstm-paper", smoke=True)
    jparams = j_get_model(cfg).init(jax.random.PRNGKey(0))
    tok = np.array(j_make_batch(cfg, j_base.SMOKE_SHAPE, seed=0)["tokens"])
    ref = {k: np.asarray(v) for k, v in jparams.items()}
    return cfg, ref, tok


@pytest.mark.parametrize("interval,nested", [(8, ()), (5, (2,))])
def test_bptt_loss_and_grad_matches_the_reference(lstm_smoke, interval,
                                                  nested):
    _, ref, tok = lstm_smoke
    j_v, j_g = j_lstm.bptt_loss_and_grad(
        {k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(tok),
        interval=interval, nested_intervals=nested)
    v, g = lstm.bptt_loss_and_grad(params_from_numpy(ref, device="cpu"),
                                   torch.as_tensor(tok), interval=interval,
                                   nested_intervals=nested)
    np.testing.assert_allclose(float(v), float(j_v), rtol=1e-5)
    for k, jg in j_g.items():
        jg = np.asarray(jg)
        np.testing.assert_allclose(g[k].numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max(), err_msg=k)
    n = tok.shape[1] - 1
    assert api.last_scan().boundaries_offloaded == -(-n // interval)


def test_front_door_scan_engine_on_lstm_smoke(lstm_smoke):
    """``value_and_grad_offloaded(engine="scan")`` on ``lstm-paper`` SMOKE,
    pinned (the plan and the gradients of the JAX package's scan engine)
    and autotuned (the same gradients; on the CPU ``T_T`` is the roofline
    estimate from the reference's ``KNL`` entry, and the plan is the one its
    interval gives).  The JAX package's own autotuned scan engine cannot
    run on this CPU: its backend reports host offload, then refuses the
    probe's ``device_put`` (the reference caveat of
    ``test_scan_engine_autotunes_inside_jit``)."""
    from repro.core import perfmodel as j_pm
    from repro.models.model_factory import get_model as j_get_model
    from repro_torch.configs import get_config
    from repro_torch.models.model_factory import get_model

    j_cfg, ref, tok = lstm_smoke
    j_v, j_g = j_api.value_and_grad_offloaded(
        j_get_model(j_cfg).train_loss, engine="scan", interval=8, slots=4)(
        {k: jnp.asarray(v) for k, v in ref.items()},
        {"tokens": jnp.asarray(tok)})
    j_plan = j_api.last_plan()
    model = get_model(get_config("lstm-paper", smoke=True))
    t_in = (params_from_numpy(ref, device="cpu"),
            {"tokens": torch.as_tensor(tok)})
    # the autotuned call measures with a tuner of its own (no cached entry)
    for kw in ({"interval": 8, "slots": 4}, {"tuner": api.AutoTuner()}):
        v, g = api.value_and_grad_offloaded(
            model.train_loss, engine="scan", device="cpu", **kw)(*t_in)
        plan, tune = api.last_plan(), api.last_tune()
        assert api.last_stats() is None
        np.testing.assert_allclose(float(v), float(j_v), rtol=1e-5)
        for k, jg in j_g.items():
            jg = np.asarray(jg)
            np.testing.assert_allclose(g[k].numpy(), jg, rtol=1e-4,
                                       atol=1e-4 * np.abs(jg).max(),
                                       err_msg=k)
        if "interval" in kw:
            assert tune.source == "manual"
            assert plan.plan_id == j_plan.plan_id
        else:
            assert tune.source == "measured" and tune.probe_calls > 0
            assert tune.t_t == tune.state_bytes / j_pm.KNL.d2h_bw
            assert plan.plan_id == sched.segment_plan(
                plan.n, tune.interval, tune.slots).plan_id
        assert api.last_scan().boundaries_offloaded == plan.num_segments


def test_front_door_scan_engine_on_a_decoder(monkeypatch):
    """A decoder through ``engine="scan"``: its stacked layers are the
    chain's inputs, so their gradients come back through the scan's
    full-chain input buffer; held against the port's dense autograd of
    ``train_loss`` and against the JAX package's scan engine (the loss in
    bf16 compute at 1e-3, and in fp32 compute, where the two packages agree
    to 1e-5, the loss at 1e-5 and every gradient leaf at 1e-4 of its max
    |g|)."""
    import _transformer_cases as tc
    from repro.models.model_factory import get_model as j_get_model
    from repro_torch.models.model_factory import get_model

    j_cfg, cfg, params, j_batch, batch = tc._case("gemma2-2b")
    model = get_model(cfg)
    ref_loss, ref_grads = tc._port_value_and_grad(model.train_loss, params,
                                                  batch)
    v, g = api.value_and_grad_offloaded(
        model.train_loss, engine="scan", interval=2, slots=1,
        device="cpu")(params_from_numpy(params, device="cpu"), batch)
    np.testing.assert_allclose(float(v), ref_loss, rtol=1e-5)
    for got, want in zip(pytree.tree_leaves(g), ref_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-6))
    plan = api.last_plan()
    assert api.last_scan().boundaries_offloaded == plan.num_segments
    j_v, _ = j_api.value_and_grad_offloaded(
        j_get_model(j_cfg).train_loss, engine="scan", interval=2, slots=1)(
        jax.tree_util.tree_map(jnp.asarray, params), j_batch)
    assert j_api.last_plan().plan_id == plan.plan_id
    np.testing.assert_allclose(float(v), float(j_v), rtol=1e-3)
    monkeypatch.setattr(tc.j_tf, "_dtypes",
                        lambda c: tc.JDTypes(compute=jnp.float32))
    monkeypatch.setattr(tc.tf, "_dtypes",
                        lambda c: tc.DTypes(compute=torch.float32))
    v32, g32 = api.value_and_grad_offloaded(
        get_model(cfg).train_loss, engine="scan", interval=2, slots=1,
        device="cpu")(params_from_numpy(params, device="cpu"), batch)
    j_v32, j_g32 = j_api.value_and_grad_offloaded(
        j_get_model(j_cfg).train_loss, engine="scan", interval=2, slots=1)(
        jax.tree_util.tree_map(jnp.asarray, params), j_batch)
    np.testing.assert_allclose(float(v32), float(j_v32), rtol=1e-5)
    la, lb = pytree.tree_leaves(g32), jax.tree_util.tree_leaves(j_g32)
    assert len(la) == len(lb)
    for got, want in zip(la, lb):
        assert tc._scaled(got.numpy(), np.asarray(want)) <= 1e-4
