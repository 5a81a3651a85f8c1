"""Parameter streaming in the port (``offload_params="moe_experts"``): a
port of ``tests/test_param_stream.py`` on ``phi3.5-moe-42b`` SMOKE cut to
4 layers, weights from the JAX package's seeded init, on the CPU.

* The streamed gradient is bit for bit the port's unstreamed one
  (``torch.equal``, loss and every leaf), and within the decoder tests'
  tolerance of the JAX package's streamed gradient; the plan and the
  parameter lane's counters (``param_prefetches``, ``param_bytes_moved``)
  equal the JAX package's.  ``param_fetch_stalls`` counts waits that found
  their blob still in flight, which depends on the threads' timing in both
  packages: it is bounded here, not compared.
* Boundary states and expert blobs share one tiered budget: at each
  capacity the measured fast-tier peak equals
  ``perfmodel.fast_peak_bytes_resources`` replayed over the port's merged
  resource plan, and the JAX package's measured peak.
* No blob outlives the run; routing counts reorder the stream, never its
  membership; the config errors are the reference's; a chain without expert
  leaves raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import _transformer_cases as tc
from repro import api as j_api
from repro.models.model_factory import get_model as j_get_model
from repro_torch import api
from repro_torch.api.frontend import _expert_leaf_ids
from repro_torch.configs import SMOKE_SHAPE, get_config
from repro_torch.configs.shapes import make_batch
from repro_torch.convert import params_from_numpy
from repro_torch.core import perfmodel as pm
from repro_torch.core import schedule as ms
from repro_torch.core.executor import ParamStream
from repro_torch.core.storage import RAMStorage, register_backend, tree_bytes
from repro_torch.models.model_factory import get_model

INTERVAL = 2


@pytest.fixture(scope="module")
def moe_setup():
    j_cfg, cfg, params, j_batch, batch = tc._case("phi3.5-moe-42b",
                                                  n_layers=4)
    m = get_model(cfg)
    p = params_from_numpy(params, device="cpu")
    ref_v, ref_g = api.value_and_grad_offloaded(
        m.train_loss, interval=INTERVAL, device="cpu")(p, batch)
    j_m = j_get_model(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    return dict(m=m, p=p, batch=batch, ref_v=ref_v, ref_g=ref_g, j_m=j_m,
                j_params=j_params, j_batch=j_batch)


def _assert_bitwise_equal(g, ref_g):
    la, lb = pytree.tree_leaves(g), pytree.tree_leaves(ref_g)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert torch.equal(a, b)


def test_streamed_grads_bit_identical(moe_setup, monkeypatch):
    """Bit for bit the unstreamed gradient; the JAX package's streamed
    gradient at the north star's 1e-4 of each leaf's max |g|, both in fp32
    compute (in bf16 the two packages route some tokens to other experts,
    see ``_transformer_cases``); the plan, the boundary lane's and the
    parameter lane's counters equal the JAX package's."""
    s = moe_setup
    vg = api.value_and_grad_offloaded(s["m"].train_loss, interval=INTERVAL,
                                      offload_params="moe_experts",
                                      device="cpu")
    v, g = vg(s["p"], s["batch"])
    assert torch.equal(v, s["ref_v"])
    _assert_bitwise_equal(g, s["ref_g"])
    st, plan = api.last_stats(), api.last_plan()
    j_v, j_g = j_api.value_and_grad_offloaded(
        s["j_m"].train_loss, interval=INTERVAL,
        offload_params="moe_experts")(s["j_params"], s["j_batch"])
    j_st = j_api.last_stats()
    assert plan.plan_id == j_api.last_plan().plan_id
    np.testing.assert_allclose(float(v), float(j_v), rtol=1e-3)
    monkeypatch.setattr(tc.j_tf, "_dtypes",
                        lambda c: tc.JDTypes(compute=jnp.float32))
    monkeypatch.setattr(tc.tf, "_dtypes",
                        lambda c: tc.DTypes(compute=torch.float32))
    v32, g32 = api.value_and_grad_offloaded(
        get_model(s["m"].cfg).train_loss, interval=INTERVAL,
        offload_params="moe_experts", device="cpu")(s["p"], s["batch"])
    j_v32, j_g32 = j_api.value_and_grad_offloaded(
        j_get_model(s["j_m"].cfg).train_loss, interval=INTERVAL,
        offload_params="moe_experts")(s["j_params"], s["j_batch"])
    np.testing.assert_allclose(float(v32), float(j_v32), rtol=1e-5)
    la, lb = pytree.tree_leaves(g32), jax.tree_util.tree_leaves(j_g32)
    assert len(la) == len(lb)
    for got, want in zip(la, lb):
        assert tc._scaled(got.numpy(), np.asarray(want)) <= 1e-4
    assert st.param_prefetches > 0
    assert st.param_bytes_moved > 0
    assert st.param_prefetches == j_st.param_prefetches
    assert st.param_bytes_moved == j_st.param_bytes_moved
    # every blob is read twice (forward and reverse), each one wait
    blobs = sum(int(np.prod(t.shape[:2])) for i, t in enumerate(
        pytree.tree_leaves(s["p"]))
        if i in _expert_leaf_ids(s["p"]))
    assert 0 <= st.param_fetch_stalls <= 2 * blobs
    # the boundary lane is the unstreamed run's
    for name in ("advances", "backwards", "l2_stores", "l2_prefetches"):
        assert getattr(st, name) == getattr(j_st, name), name


def test_streamed_call_autotunes_with_the_lane(moe_setup):
    """Autotuned, the streamed call keys its schedule apart (``:pstream``),
    probes one step and times the lane's reads (``t_t_param``)."""
    s = moe_setup
    v, g = api.value_and_grad_offloaded(
        s["m"].train_loss, offload_params="moe_experts",
        tuner=api.AutoTuner(), device="cpu")(s["p"], s["batch"])
    tune = api.last_tune()
    assert tune.source == "measured" and tune.probe_calls > 0
    assert tune.probe_len == 1
    assert tune.t_t_param > 0.0
    assert all(bool(t.isfinite().all()) for t in pytree.tree_leaves(g))


def test_streamed_tiered_shares_capacity_and_replays_peak(moe_setup):
    """Boundary states and expert blobs under one tiered budget: the
    measured fast-tier peak equals the perfmodel replay of the merged
    ResourceAccessPlan at every capacity, and the JAX package's; gradients
    never change."""
    s = moe_setup
    spec = s["m"].train_loss.chain_spec
    carry0, xs = spec.prelude(s["p"], s["batch"])
    state_bytes = tree_bytes(carry0)
    leaf_ids = _expert_leaf_ids(xs)
    assert leaf_ids                        # the MoE chain must expose blobs
    flat = pytree.tree_leaves(xs)
    leaves = {i: flat[i] for i in leaf_ids}
    n_experts = next(iter(leaves.values())).shape[1]

    for cap in (1 << 22, 1 << 19, 1 << 17):
        vg = api.value_and_grad_offloaded(
            s["m"].train_loss, interval=INTERVAL, storage="tiered",
            l2_capacity_bytes=cap, offload_params="moe_experts",
            device="cpu")
        v, g = vg(s["p"], s["batch"])
        assert torch.equal(v, s["ref_v"])
        _assert_bitwise_equal(g, s["ref_g"])
        st, plan = api.last_stats(), api.last_plan()
        assert st.l2_fast_peak_bytes <= cap
        ps = ParamStream(None, leaves, n_experts=n_experts)
        ps.bind(plan)
        puts = [(k, ps.blob_bytes[k[1]]) for k in ps.population_order()]
        puts += [(seg.begin, state_bytes) for seg in plan.segments]
        dist = ms.merge_access_plans(
            ps.access_plan("forward"),
            plan.resource_access_plan(state_bytes)
            .shift(len(plan.segments))).distances()
        assert st.l2_fast_peak_bytes == \
            pm.fast_peak_bytes_resources(puts, dist, cap)
        j_api.value_and_grad_offloaded(
            s["j_m"].train_loss, interval=INTERVAL, storage="tiered",
            l2_capacity_bytes=cap, offload_params="moe_experts")(
            s["j_params"], s["j_batch"])
        j_st = j_api.last_stats()
        assert st.l2_fast_peak_bytes == j_st.l2_fast_peak_bytes, cap
        assert st.param_bytes_moved == j_st.param_bytes_moved, cap


def test_expert_blobs_purged_after_run(moe_setup):
    """The transient expert blobs must not outlive the run: after the
    gradient returns, no ("xp", ...) key is left in Level 2."""
    s = moe_setup
    instances = []

    def factory():
        b = RAMStorage()
        instances.append(b)
        return b

    register_backend("param-stream-probe", factory)
    vg = api.value_and_grad_offloaded(s["m"].train_loss, interval=INTERVAL,
                                      storage="param-stream-probe",
                                      offload_params="moe_experts",
                                      device="cpu")
    v, g = vg(s["p"], s["batch"])
    _assert_bitwise_equal(g, s["ref_g"])
    assert instances
    leftover = [k for k in instances[-1].keys()
                if isinstance(k, tuple) and k and k[0] == "xp"]
    assert leftover == []


def test_routing_counts_reorder_plan_not_membership():
    """Routing statistics only reorder the intra-step eviction priority;
    the set of streamed keys per segment is unchanged (every expert is
    still fetched)."""
    leaves = {3: torch.zeros((4, 2, 8, 16))}
    plan = ms.segment_plan(n=4, interval=2, s_l1=2)
    counts = np.array([[0, 9]] * 4)        # expert 1 busiest every step
    ps_uniform = ParamStream(None, leaves, n_experts=2)
    ps_counts = ParamStream(None, leaves, n_experts=2, expert_counts=counts)
    ps_uniform.bind(plan)
    ps_counts.bind(plan)
    seg = plan.segments[0]
    ku = ps_uniform.segment_keys(seg)
    kc = ps_counts.segment_keys(seg)
    assert sorted(ku) == sorted(kc)        # same membership
    assert ku != kc                        # different priority order
    assert kc[0] == ms.expert_key(3, seg.end - 1, 1)   # busiest first
    last = plan.segments[-1]
    kl = ps_counts.segment_keys(last)
    ap = ps_counts.access_plan("reverse")
    assert [a.key for a in ap.accesses[:len(kl)]] == list(kl)


def test_offload_params_validation():
    bad = [
        dict(offload_params="fft_twiddles"),
        dict(offload_params="moe_experts", strategy="revolve"),
        dict(offload_params="moe_experts", engine="interpreted"),
        dict(offload_params="moe_experts", engine="scan"),
        dict(offload_params="moe_experts", runner="fused"),
        dict(offload_params="moe_experts", storage="compressed"),
        dict(offload_params="moe_experts", journal_dir="/tmp/x"),
        dict(offload_params="moe_experts", step_memory_budget=1 << 20),
        dict(offload_params="moe_experts", plan_2d=(2, 1)),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            api.OffloadConfig(**kw)
    api.OffloadConfig(offload_params="moe_experts")


def test_offload_params_needs_expert_leaves():
    """A chain with no per-expert leaves fails fast with a clear error
    instead of silently streaming nothing."""
    cfg = get_config("lstm-paper", smoke=True)
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, SMOKE_SHAPE, 0, device="cpu")
    vg = api.value_and_grad_offloaded(m.train_loss, interval=2,
                                      offload_params="moe_experts",
                                      device="cpu")
    with pytest.raises(Exception, match="no per-expert"):
        vg(params, batch)


def test_offloaded_loss_under_plain_autograd(moe_setup):
    """``offloaded_loss`` with ``offload_params=`` under plain
    ``torch.autograd``: every leaf, the streamed ones too, gets the
    transform's gradient bit for bit (a streamed leaf that wants a gradient
    gets it from the run's buffer, on the leaf's device), and the front
    door's side channel for streamed gradients keeps none of them."""
    from repro_torch.api import frontend as fe

    s = moe_setup
    cfg = fe.OffloadConfig(interval=INTERVAL, offload_params="moe_experts")
    loss_fn = fe.offloaded_loss(s["m"].train_loss.chain_spec, cfg)
    leaves, spec = pytree.tree_flatten(s["p"])
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    v = loss_fn(pytree.tree_unflatten(leaves, spec), s["batch"])
    fe._LAST["streamed_grads"] = {}
    grads = torch.autograd.grad(v, leaves)
    assert fe._LAST["streamed_grads"] == {}
    assert torch.equal(v.detach(), s["ref_v"])
    _assert_bitwise_equal(list(grads), s["ref_g"])
