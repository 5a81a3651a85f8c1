"""The port's 2D (time x layer) plans against the JAX package's, on the CPU.

Case for case as ``tests/test_plan2d.py``: the chunked loss head, the
budget-driven and pinned 2D plans through ``value_and_grad_offloaded``,
infeasible budgets, the config's validation and the planner units.  Then:

* the planner on one profile: the JAX package's byte profile, fed to the
  port's ``choose_2d_plan`` and ``AutoTuner.plan_2d``, gives the JAX
  package's ``Plan2D`` field for field;
* the port's byte profile (meta tensors, core ATen operations) against the
  JAX package's (jaxpr primitives): one carry's bytes equal, each layer's
  and the head's within a factor of 2 (the measured ratios are written in
  :data:`PROFILE_RATIOS`), and the meta count equal to the count on real
  CPU tensors;
* end to end with JAX weights (``convert.params_from_numpy``) in fp32
  compute: granite-3-2b under a budget from each package's own profile,
  gemma2-2b with ``plan_2d=(2, 1)`` and ``(2, 3)``, jamba-v0.1-52b under a
  budget that splits its 8-layer period.  The loss within 1e-5 relative
  and each gradient leaf within 1e-4 of its max |g| against the JAX call
  and against the port's dense autograd; the plan id, the inner counters
  and ``inner_recompute_factor == 1.0`` equal to the JAX run's;
  ``inner_peak_bytes`` equal to the model; a one-head-chunk 2D gradient
  bit for bit the port's 1D gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.models.transformer as j_tf
from _transformer_cases import (_case, _jax_value_and_grad,
                                _port_value_and_grad, _scaled)
from repro import api as j_api
from repro.analysis.jaxpr_cost import \
    chain_step_byte_profile as j_byte_profile
from repro.api.chain import index_xs as j_index_xs
from repro.core import perfmodel as j_pm
from repro.models.layers import DTypes as JDTypes
from repro.models.model_factory import get_model as j_get_model
from repro_torch import api
from repro_torch.analysis import byte_profile as bp
from repro_torch.api import frontend as fe
from repro_torch.api.chain import chain_length, index_xs
from repro_torch.configs import SMOKE_SHAPE, get_config
from repro_torch.configs.shapes import make_batch
from repro_torch.convert import params_from_numpy
from repro_torch.core import perfmodel as pm
from repro_torch.core.storage import tree_bytes
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTypes, chunked_ce_loss
from repro_torch.models.model_factory import get_model

INNER = ("inner_layer_chunks", "inner_head_chunks", "inner_layers",
         "inner_recomputed_layers", "inner_peak_bytes")
COUNTERS = ("advances", "backwards", "l2_stores", "host_dispatches",
            "l2_peak_bytes") + INNER

# port / JAX package, measured at SMOKE width and shape (bf16 compute):
# (each layer's bytes, the head's bytes).  The port counts core ATen
# operations, the JAX package jaxpr primitives; gemma2's layers are lower
# because its softcapped attention's tanh/where chain is fused into fewer
# ATen operations on the dense path.
PROFILE_RATIOS = {
    "granite-3-2b": ((0.931,), 0.996),
    "gemma2-2b": ((0.781, 0.775), 0.998),
    "jamba-v0.1-52b": ((1.024, 1.062, 1.024, 1.003, 1.024, 1.062, 1.024,
                        1.062), 0.996),
}


def _port_params(params):
    return params_from_numpy(params, device="cpu")


def _fp32(monkeypatch):
    monkeypatch.setattr(j_tf, "_dtypes",
                        lambda c: JDTypes(compute=jnp.float32))
    monkeypatch.setattr(tf, "_dtypes", lambda c: DTypes(compute=torch.float32))


def _leaves(tree):
    return [t.detach().numpy() for t in pytree.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# chunked loss head
# ---------------------------------------------------------------------------


def test_chunked_ce_fp32_nondividing_vocab():
    """fp32 CE gradients across head chunkings, with a prime vocab (97)
    and a prime sequence length (31).  The JAX package's version of this
    case gates bit-identity and fails in the JAX package itself (ROADMAP
    queue 3), so the port is held at allclose 1e-6 here, and its values
    against the JAX package's at the same tolerance."""
    from repro.models.layers import chunked_ce_loss as j_ce

    B, S, D, V = 2, 31, 16, 97
    rng = np.random.default_rng(0)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S))

    def vg(chunk):
        hh = torch.tensor(h, requires_grad=True)
        loss = chunked_ce_loss(hh, torch.tensor(w), torch.tensor(labels),
                               chunk=chunk)
        (g,) = torch.autograd.grad(loss, hh)
        return float(loss.detach()), g.numpy()

    ref_v, ref_g = vg(S)
    j_v, j_g = jax.value_and_grad(lambda hh: j_ce(
        hh, jnp.asarray(w), jnp.asarray(labels), chunk=S))(jnp.asarray(h))
    np.testing.assert_allclose(ref_g, np.asarray(j_g), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ref_v, float(j_v), rtol=1e-6)
    for chunk in (31, 7, 5, 4, 1):
        v, g = vg(chunk)
        np.testing.assert_allclose(g, ref_g, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(v, ref_v, rtol=1e-6)


def test_whisper_tiny_chunked_head_parity(monkeypatch):
    """The whisper-tiny decoder's logits/CE head at fp32, on hidden states
    the port's ``encdec`` computes from the JAX package's weights, for
    chunkings of 31 positions that nothing divides.  The JAX package holds
    the per-position gradients bit for bit; the port's CPU matmul blocks
    a ``(B, chunk, V)`` product by its shape, so a position's row may sum
    in another order: held at allclose 1e-6 (bitwise chunk invariance is
    not a gate of the port, ROADMAP queue 3).  The tied-embedding gradient
    (a reduction over positions) at the JAX package's allclose."""
    from repro_torch.models import encdec
    from repro_torch.models.layers import embed, rmsnorm, rope_table

    j_cfg, cfg, params, _, batch = _case("whisper-tiny")
    p = _port_params(params)
    tokens = batch["tokens"]
    labels = tokens[:, 1:]
    S = int(labels.shape[1])
    dt = encdec._dtypes(cfg)
    with torch.no_grad():
        enc = encdec.encode(p, batch["frames"], cfg)
        x = embed(p["embed"], tokens[:, :-1], dt)
        rope = rope_table(S, cfg.hd, cfg.rope_theta)
        for lp in tf._periods(p["dec_layers"]):
            x = encdec._dec_layer_seq(lp, x, enc, rope, cfg, dt)
        h = rmsnorm(p["final_norm"], x, dt=dt).float()
    w = p["embed"]["emb"].float()

    def head(chunk):
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        loss = chunked_ce_loss(hh, ww, labels, chunk=chunk)
        gh, gw = torch.autograd.grad(loss, (hh, ww))
        return float(loss.detach()), gh, gw

    ref_v, ref_gh, ref_gw = head(S)
    for chunk in (S, 7, 3):
        v, gh, gw = head(chunk)
        np.testing.assert_allclose(gh.numpy(), ref_gh.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"chunk={chunk}")
        np.testing.assert_allclose(gw.numpy(), ref_gw.numpy(), rtol=1e-5,
                                   atol=1e-7)
        assert abs(v - ref_v) <= 1e-6


def test_gemma2_chunked_readout_grad_parity():
    """gemma2-2b's ``readout_chunked``: equal to ``readout`` at
    ``head_chunks=1``; its gradient in the carry equal for 1, 3 and 5 head
    chunks (3 and 5 do not divide 31)."""
    cfg = get_config("gemma2-2b", smoke=True)
    m = get_model(cfg)
    spec = m.train_chain
    assert spec.supports_2d and spec.readout_chunked is not None
    params = m.init(torch.Generator().manual_seed(4), device="cpu")
    batch = make_batch(cfg, SMOKE_SHAPE, 0, device="cpu")
    with torch.no_grad():
        c, xs = spec.prelude(params, batch)
        for k in range(chain_length(xs)):
            c = spec.body(params, c, index_xs(xs, k), batch)
        assert float(spec.readout_chunked(params, c, batch, 1)) == \
            float(spec.readout(params, c, batch))

    def vg(fn):
        cc = tuple(t.clone().requires_grad_(True) for t in c)
        v = fn(cc)
        return float(v.detach()), torch.autograd.grad(v, cc)

    ref_v, ref_g = vg(lambda cc: spec.readout(params, cc, batch))
    for hc in (1, 3, 5):
        v, g = vg(lambda cc: spec.readout_chunked(params, cc, batch, hc))
        assert all(torch.equal(a, b) for a, b in zip(g, ref_g)), hc
        assert abs(v - ref_v) <= 1e-4


# ---------------------------------------------------------------------------
# end to end: 2D plans through value_and_grad_offloaded, against JAX
# ---------------------------------------------------------------------------


def _j_profile(j_cfg, params, j_batch):
    spec = j_get_model(j_cfg).train_chain
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    carry0, xs = spec.prelude(jp, j_batch)
    return j_byte_profile(spec, jp, carry0, j_index_xs(xs, 0), j_batch)


def _t_profile(cfg, params, batch):
    spec = get_model(cfg).train_chain
    p = _port_params(params)
    carry0, xs = spec.prelude(p, batch)
    return bp.chain_step_byte_profile(spec, p, carry0, index_xs(xs, 0),
                                      batch)


def _run_both(j_cfg, cfg, params, j_batch, batch, interval, slots, j_kw,
              t_kw):
    """The JAX call and the port's call; returns both (value, leaves,
    plan, stats)."""
    j_vg = j_api.value_and_grad_offloaded(
        j_get_model(j_cfg).train_loss, interval=interval, slots=slots,
        **j_kw)
    j_v, j_g = j_vg(jax.tree_util.tree_map(jnp.asarray, params), j_batch)
    j_out = (float(j_v), [np.asarray(g) for g in
                          jax.tree_util.tree_leaves(j_g)],
             j_api.last_plan(), j_api.last_stats())
    vg = api.value_and_grad_offloaded(get_model(cfg).train_loss,
                                      interval=interval, slots=slots,
                                      device="cpu", **t_kw)
    v, g = vg(_port_params(params), batch)
    return j_out, (float(v), _leaves(g), api.last_plan(), api.last_stats())


def _check_2d(j_out, out, ref_dense, carry0_bytes, n):
    j_v, j_g, j_plan, j_st = j_out
    v, g, plan, st = out
    d_v, d_g = ref_dense
    for ref_v, ref_g in ((j_v, j_g), (d_v, d_g)):
        np.testing.assert_allclose(v, ref_v, rtol=1e-5)
        for a, b in zip(g, ref_g):
            assert _scaled(a, b) <= 1e-4
    inner = plan.inner
    assert inner is not None
    assert dataclasses.asdict(inner) == dataclasses.asdict(j_plan.inner)
    assert plan.plan_id == j_plan.plan_id
    assert plan.plan_id.endswith(
        f":L={inner.layer_chunks}:H={inner.head_chunks}")
    for name in COUNTERS:
        assert getattr(st, name) == getattr(j_st, name), name
    assert st.inner_recompute_factor == j_st.inner_recompute_factor == 1.0
    assert st.inner_recomputed_layers == \
        pm.inner_recomputed_layers_model(n, inner)
    assert st.inner_peak_bytes == \
        int(pm.inner_boundary_bytes_model(inner, carry0_bytes))


def test_budget_forces_2d_plan_grads_match_jax(monkeypatch):
    """granite-3-2b under ``sum(layer_bytes) + head_bytes - 1`` of each
    package's own profile: a 2D plan, gradients as the JAX call's and as
    dense autograd's, counters as the JAX run's."""
    _fp32(monkeypatch)
    j_cfg, cfg, params, j_batch, batch = _case("granite-3-2b", n_layers=4)
    j_sb, j_lb, j_hb = _j_profile(j_cfg, params, j_batch)
    sb, lb, hb = _t_profile(cfg, params, batch)
    j_budget = int(sum(j_lb) + j_hb) - 1
    budget = int(sum(lb) + hb) - 1
    assert budget > pm.choose_2d_plan(
        4, t_a=1.0, t_t=0.0, s_l1=2, state_bytes=sb, layer_bytes=lb,
        budget_bytes=budget, head_bytes=hb, interval=1).min_budget_bytes
    dense = _port_value_and_grad(get_model(cfg).train_loss, params, batch)
    j_out, out = _run_both(j_cfg, cfg, params, j_batch, batch, 2, 2,
                           {"step_memory_budget": j_budget},
                           {"step_memory_budget": budget})
    _check_2d(j_out, out, dense, sb, 4)
    # one head chunk in fp32: bit for bit the port's 1D gradient
    assert out[2].inner.head_chunks == 1
    vg1 = api.value_and_grad_offloaded(get_model(cfg).train_loss,
                                       interval=2, slots=2, device="cpu")
    v1, g1 = vg1(_port_params(params), batch)
    assert float(v1) == out[0]
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(g1), out[1]))


@pytest.mark.parametrize("plan_2d", [(2, 1), (2, 3)])
def test_gemma2_pinned_plan_2d_matches_jax(plan_2d, monkeypatch):
    """gemma2-2b (two periods of ``("attn_local", "attn")``) with both
    layers of a period in chunks of their own, and the head in 1 or 3
    chunks (3 widens the CE chunk past ``ce_chunk``, as the JAX package's
    ``readout_chunked`` does)."""
    _fp32(monkeypatch)
    j_cfg, cfg, params, j_batch, batch = _case("gemma2-2b", n_layers=4)
    dense = _port_value_and_grad(get_model(cfg).train_loss, params, batch)
    j_out, out = _run_both(j_cfg, cfg, params, j_batch, batch, 1, 2,
                           {"plan_2d": plan_2d}, {"plan_2d": plan_2d})
    spec = get_model(cfg).train_chain
    carry0, _ = spec.prelude(_port_params(params), batch)
    _check_2d(j_out, out, dense, tree_bytes(carry0), 2)
    assert out[2].plan_id.endswith(":L=%d:H=%d" % plan_2d)
    if plan_2d[1] == 1:
        vg1 = api.value_and_grad_offloaded(get_model(cfg).train_loss,
                                           interval=1, slots=2,
                                           device="cpu")
        v1, g1 = vg1(_port_params(params), batch)
        assert float(v1) == out[0]
        assert all(np.array_equal(a, b)
                   for a, b in zip(_leaves(g1), out[1]))


def test_jamba_budget_splits_the_period(monkeypatch):
    """jamba-v0.1-52b (16 layers: two 8-layer periods, one segment each)
    in fp32 under 60% of one period's bytes from each package's own
    profile: the plan splits the period (``layer_chunks > 1``), as the JAX
    package's does."""
    _fp32(monkeypatch)
    j_cfg, cfg, params, j_batch, batch = _case("jamba-v0.1-52b",
                                               n_layers=16)
    _, j_lb, _ = _j_profile(j_cfg, params, j_batch)
    sb, lb, _ = _t_profile(cfg, params, batch)
    j_budget, budget = int(0.6 * sum(j_lb)), int(0.6 * sum(lb))
    dense = _port_value_and_grad(get_model(cfg).train_loss, params, batch)
    j_out, out = _run_both(j_cfg, cfg, params, j_batch, batch, 1, 2,
                           {"step_memory_budget": j_budget},
                           {"step_memory_budget": budget})
    assert out[2].inner.layer_chunks > 1
    _check_2d(j_out, out, dense, sb, 2)


def test_pinned_plan_2d_head_chunks_bf16():
    """``plan_2d=(1, 3)`` in bf16 (the JAX package's case): the plan id
    ends in ``:L=1:H=3``; the loss within 1e-4 and the gradients close to
    the port's dense autograd (the head's bf16 sums reassociate)."""
    j_cfg, cfg, params, j_batch, batch = _case("granite-3-2b")
    d_v, d_g = _port_value_and_grad(get_model(cfg).train_loss, params,
                                    batch)
    vg = api.value_and_grad_offloaded(get_model(cfg).train_loss, interval=2,
                                      slots=2, plan_2d=(1, 3), device="cpu")
    v, g = vg(_port_params(params), batch)
    assert api.last_plan().plan_id.endswith(":L=1:H=3")
    assert abs(float(v) - d_v) <= 1e-4
    for a, b in zip(_leaves(g), d_g):
        assert _scaled(a, b) <= 1e-2


def test_infeasible_budget_names_smallest_feasible():
    cfg = get_config("granite-3-2b", smoke=True)
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(7), device="cpu")
    batch = make_batch(cfg, SMOKE_SHAPE, 0, device="cpu")
    vg = api.value_and_grad_offloaded(m.train_loss, interval=2, slots=2,
                                      step_memory_budget=1000, device="cpu")
    with pytest.raises(ValueError,
                       match=r"smallest feasible budget is \d+ bytes"):
        vg(params, batch)


def test_2d_needs_layer_decomposition():
    spec = api.ChainSpec(
        prelude=lambda p, b: (torch.zeros(()), b["xs"]),
        body=lambda p, c, x, b: c + p * torch.tanh(x),
        readout=lambda p, c, b: c ** 2,
        name="no-2d-chain")
    vg = api.value_and_grad_offloaded(spec, interval=2,
                                      step_memory_budget=100, device="cpu")
    with pytest.raises(ValueError, match="layer decomposition"):
        vg(torch.tensor(0.5), {"xs": torch.linspace(-1.0, 1.0, 8)})


@pytest.mark.parametrize("kw,match", [
    ({"step_memory_budget": 0}, "positive byte count"),
    ({"plan_2d": (0, 1)}, "layer_chunks, head_chunks"),
    ({"step_memory_budget": 1, "plan_2d": (1, 1)}, "not both"),
    ({"step_memory_budget": 1, "engine": "interpreted"}, "compiled engine"),
    ({"step_memory_budget": 1, "runner": "PALLAS"}, "runner='compiled'"),
    ({"plan_2d": (1, 2), "strategy": "revolve"}, "no such sweep"),
    ({"plan_2d": (1, 2), "offload_params": "moe_experts"}, "2D plans"),
])
def test_offload_config_2d_validation(kw, match):
    """The JAX package's ``ValueError``s, with the same knob in both
    messages (``runner='fused'`` is the JAX package's ``'pallas'``)."""
    from repro.api.frontend import OffloadConfig as JConfig

    j_kw = {k: ("pallas" if v == "PALLAS" else v) for k, v in kw.items()}
    t_kw = {k: ("fused" if v == "PALLAS" else v) for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        JConfig(**j_kw)
    with pytest.raises(ValueError, match=match):
        fe.OffloadConfig(**t_kw)
    # valid configs construct
    fe.OffloadConfig(step_memory_budget=1 << 20)
    fe.OffloadConfig(plan_2d=(2, 3))


# ---------------------------------------------------------------------------
# planner units: DP, perfmodel, tuner coupling
# ---------------------------------------------------------------------------


def test_gruslys_split_minmax_boundaries():
    from repro.core.schedule import gruslys_split as j_split
    from repro_torch.core.schedule import (gruslys_split,
                                           min_step_budget_bytes)

    layer_bytes = (100.0, 10.0, 10.0, 100.0)
    state = 5.0
    p = gruslys_split(layer_bytes, 1000.0, state)
    assert p.layer_chunks == 1 and p.boundaries == (0,)
    p = gruslys_split(layer_bytes, 130.0, state)
    worst = max(sum(layer_bytes[lo:hi]) for lo, hi in p.chunk_ranges())
    assert p.layer_chunks * state + worst <= 130.0
    assert dataclasses.asdict(p) == dataclasses.asdict(
        j_split(layer_bytes, 130.0, state))
    assert gruslys_split(layer_bytes, 50.0, state) is None
    assert min_step_budget_bytes(layer_bytes, state) <= 130.0


def test_choose_2d_plan_1d_when_it_fits():
    plan = pm.choose_2d_plan(16, t_a=1.0, t_t=2.0, s_l1=4,
                             state_bytes=10.0, layer_bytes=(50.0, 50.0),
                             budget_bytes=500.0, head_bytes=100.0)
    assert not plan.is_2d and plan.feasible
    assert plan.step_peak_bytes == plan.step_bytes_1d == 200.0


def test_choose_2d_plan_chunks_layers_and_head():
    plan = pm.choose_2d_plan(16, t_a=1.0, t_t=2.0, s_l1=4,
                             state_bytes=10.0, layer_bytes=(50.0,) * 8,
                             budget_bytes=150.0, head_bytes=400.0)
    assert plan.is_2d and plan.feasible
    inner = plan.inner
    assert inner.layer_chunks > 1
    assert inner.head_chunks == 3          # ceil(400 / 150)
    assert plan.step_peak_bytes <= 150.0
    assert plan.inner_boundary_bytes == inner.layer_chunks * 10.0
    base = pm.recompute_factor_2d(16, plan.interval, 4, None)
    assert plan.recompute_factor == pytest.approx(base + 16.0 / 15.0)


def test_autotuner_plan_2d_uses_measured_schedule():
    tuner = api.AutoTuner()
    tune = tuner.manual("t2d", n=32, interval=8, slots=4)
    plan = tuner.plan_2d(tune, n=32, state_bytes=8.0,
                         layer_bytes=(64.0, 64.0, 64.0), budget_bytes=120.0)
    assert plan.interval == 8
    assert plan.is_2d and plan.feasible
    plan1d = tuner.plan_2d(tune, n=32, state_bytes=8.0,
                           layer_bytes=(64.0, 64.0, 64.0),
                           budget_bytes=10_000.0)
    assert not plan1d.is_2d


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-2b"])
def test_planner_on_the_jax_profile_equals_jax(arch):
    """The JAX package's byte profile, fed to the port's planner and to
    the JAX package's at budgets from 1D-fits to infeasible: the same
    ``Plan2D``, field for field, from ``choose_2d_plan`` and from
    ``AutoTuner.plan_2d``."""
    j_cfg, _, params, j_batch, _ = _case(arch, n_layers=4)
    sb, lb, hb = _j_profile(j_cfg, params, j_batch)
    min_b = j_pm.choose_2d_plan(4, t_a=1.0, t_t=0.0, s_l1=2, state_bytes=sb,
                                layer_bytes=lb, budget_bytes=1.0,
                                head_bytes=hb).min_budget_bytes
    budgets = (sum(lb) + hb + 1, sum(lb) + hb - 1, 0.6 * sum(lb), min_b,
               min_b - 1, 0.3 * hb)
    j_tuner = j_api.AutoTuner()
    tuner = api.AutoTuner()
    j_tune = j_tuner.manual("p2d", n=4, interval=2, slots=2)
    tune = tuner.manual("p2d", n=4, interval=2, slots=2)
    for budget in budgets:
        kw = dict(state_bytes=sb, layer_bytes=lb, budget_bytes=budget,
                  head_bytes=hb)
        j_plan = j_pm.choose_2d_plan(4, t_a=1.0, t_t=0.0, s_l1=2,
                                     interval=1, **kw)
        plan = pm.choose_2d_plan(4, t_a=1.0, t_t=0.0, s_l1=2, interval=1,
                                 **kw)
        assert dataclasses.asdict(plan) == dataclasses.asdict(j_plan)
        assert dataclasses.asdict(tuner.plan_2d(tune, n=4, **kw)) == \
            dataclasses.asdict(j_tuner.plan_2d(j_tune, n=4, **kw))


# ---------------------------------------------------------------------------
# the byte profile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(PROFILE_RATIOS))
def test_byte_profile_against_jax(arch):
    """State bytes equal; each layer's and the head's bytes within a
    factor of 2 of the JAX package's, at the ratios measured here."""
    j_cfg, cfg, params, j_batch, batch = _case(arch)
    j_sb, j_lb, j_hb = _j_profile(j_cfg, params, j_batch)
    sb, lb, hb = _t_profile(cfg, params, batch)
    assert sb == j_sb
    assert len(lb) == len(j_lb) == get_model(cfg).train_chain.n_layers
    layer_ratios, head_ratio = PROFILE_RATIOS[arch]
    for b, jb, want in zip(lb, j_lb, layer_ratios):
        assert 0.5 <= b / jb <= 2.0
        assert round(b / jb, 3) == want
    assert 0.5 <= hb / j_hb <= 2.0
    assert round(hb / j_hb, 3) == head_ratio


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-2b"])
def test_byte_profile_meta_equals_real(arch):
    """The profile on meta tensors is the same count as on real CPU
    tensors (the decoders' dense layers and head; a MoE layer's
    ``one_hot`` reads the data on real tensors to check its range, so the
    operation sequence differs there)."""
    _, cfg, params, _, batch = _case(arch)
    spec = get_model(cfg).train_chain
    p = _port_params(params)
    carry, xs = spec.prelude(p, batch)
    x0 = index_xs(xs, 0)
    sb, lb, hb = bp.chain_step_byte_profile(spec, p, carry, x0, batch)
    real = []
    for j in range(spec.n_layers):
        nbytes, carry = bp.op_bytes(
            lambda pp, cc, xx, bb, j=j: spec.layer_body(pp, cc, xx, bb, j),
            p, carry, x0, batch)
        assert carry[0].device.type == "cpu"
        real.append(float(nbytes))
    assert tuple(real) == lb
    assert float(bp.op_bytes(spec.readout, p, carry, batch)[0]) == hb
    assert sb == tree_bytes(carry)


def test_byte_profile_shapes_only_and_data_dependent_ops_raise():
    """The profile runs on meta stand-ins (nothing is computed), and an
    operation whose output shape depends on the data raises, naming it
    (the sorted MoE dispatch's boolean-mask scatter)."""
    cfg = get_config("granite-3-2b", smoke=True)
    m = get_model(cfg)
    spec = m.train_chain
    params = m.init(torch.Generator().manual_seed(8), device="cpu")
    batch = make_batch(cfg, SMOKE_SHAPE, 0, device="cpu")
    carry0, xs = spec.prelude(params, batch)
    seen = []
    orig = spec.layer_body

    def spy(p, c, x, b, j):
        seen.append(c[0].device.type)
        return orig(p, c, x, b, j)

    spied = dataclasses.replace(spec, layer_body=spy)
    sb, lb, hb = bp.chain_step_byte_profile(spied, params, carry0,
                                            index_xs(xs, 0), batch)
    assert seen == ["meta"] * spec.n_layers
    assert sb > 0 and hb > 0 and all(b > 0 for b in lb)
    with pytest.raises(ValueError, match="nonzero"):
        bp.op_bytes(lambda t: t[t > 0], torch.empty(4, device="meta"))
    moe = get_model(get_config("phi3.5-moe-42b", smoke=True).replace(
        moe_impl="sorted", n_layers=1))
    mp = moe.init(torch.Generator().manual_seed(0), device="cpu")
    mb = make_batch(moe.cfg, SMOKE_SHAPE, 0, device="cpu")
    c0, mxs = moe.train_chain.prelude(mp, mb)
    with pytest.raises(ValueError, match="depends on the data"):
        bp.chain_step_byte_profile(moe.train_chain, mp, c0,
                                   index_xs(mxs, 0), mb)
