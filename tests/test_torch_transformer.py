"""The port's decoder families (``gemma2-2b`` dense, ``mamba2-370m`` SSM)
against the JAX package, on the CPU at SMOKE width.

Weights come from the JAX package's ``init_lm``, carried over by
``repro_torch.convert``; batches from both packages' ``make_batch`` (equal
tokens).  Tolerances:

* ``train_loss`` against JAX: loss 1e-3 relative, each gradient leaf 3e-2
  of its max |g|.  Both sides compute in bf16 and round in different
  places.  JAX's CPU backend reduces a broadcast bf16 gradient (mamba's
  ``D``) in bf16 and lands farther than that from the fp32-compute
  gradient; a leaf whose JAX gradient is itself more than 3e-2 off the
  fp32-compute one is held against the fp32-compute gradient instead, at
  the same 3e-2.  In fp32 compute the two packages agree to 1e-5.
* The offloaded gradient (``runner="compiled"``) against the port's own
  dense autograd of ``train_loss``: loss 1e-5 relative, each leaf 1e-4 of
  its max |g|; the plan, the schedule and the executor counters equal the
  JAX package's for the same ``(n, I, s)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.models.transformer as j_tf
from repro import api as j_api
from repro.configs import base as j_base
from repro.configs.registry import get_config as j_get_config
from repro.configs.shapes import make_batch as j_make_batch
from repro.models.layers import DTypes as JDTypes
from repro.models.model_factory import get_model as j_get_model
from repro_torch import api
from repro_torch.configs import SMOKE_SHAPE, ShapeSpec, get_config
from repro_torch.configs.shapes import make_batch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTypes
from repro_torch.models.model_factory import get_model

ARCHS = ("gemma2-2b", "mamba2-370m")
COUNTERS = ("advances", "backwards", "l2_stores", "host_dispatches",
            "fused_segments", "fused_boundary_copies", "l2_peak_bytes")


def _configs(arch, **kw):
    return (j_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _case(arch, seq=None, batch=None, **kw):
    """(jax cfg, port cfg, numpy params, jax batch, port batch)."""
    j_cfg, cfg = _configs(arch, **kw)
    S = seq or SMOKE_SHAPE.seq_len
    B = batch or SMOKE_SHAPE.global_batch
    j_batch = j_make_batch(j_cfg, j_base.ShapeSpec("t", S, B, "train"), 0)
    batch_ = make_batch(cfg, ShapeSpec("t", S, B, "train"), 0, device="cpu")
    params = jax.tree_util.tree_map(
        np.asarray, j_get_model(j_cfg).init(jax.random.PRNGKey(0)))
    return j_cfg, cfg, params, j_batch, batch_


def _port_value_and_grad(loss_fn, params, batch):
    leaves, spec = pytree.tree_flatten(params_from_numpy(params,
                                                         device="cpu"))
    leaves = [t.requires_grad_(True) for t in leaves]
    loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _jax_value_and_grad(loss_fn, params, batch):
    loss, grads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params), batch)
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(
        grads)]


def _shapes(tree, prefix=""):
    """{"a/b/c": shape} of a nested dict (key order aside)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


def _scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(j_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_and_param_tree_carry_over(arch):
    j_cfg, cfg, params, j_batch, batch = _case(arch)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(j_batch["tokens"]))
    back = params_to_numpy(params_from_numpy(params, device="cpu"))
    assert pytree.tree_structure(back) == pytree.tree_structure(params)
    for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the port's own init draws another stream into the same tree
    ours = get_model(cfg).init(torch.Generator().manual_seed(0),
                               device="cpu")
    assert _shapes(ours) == _shapes(params)
    assert all(t.dtype == torch.float32 for t in pytree.tree_leaves(ours))
    if arch == "mamba2-370m":   # the deterministic leaves equal JAX's
        for k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
            np.testing.assert_allclose(
                ours["layers"]["pos0"]["mamba"][k].numpy(),
                params["layers"]["pos0"]["mamba"][k], rtol=1e-6)


@pytest.mark.parametrize("arch,seq,batch,kw", [
    ("gemma2-2b", None, None, {}),
    ("mamba2-370m", None, None, {}),
    # S > 2048: the chunked attention path (its plain forward and the
    # flash-style backward) at one period of the local/global pattern, over
    # three KV chunks
    ("gemma2-2b", 2064, 1, {"attn_chunk": 688}),
])
def test_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch):
    j_cfg, cfg, params, j_batch, t_batch = _case(arch, seq, batch, **kw)
    j_loss, j_grads = _jax_value_and_grad(
        j_get_model(j_cfg).train_loss, params, j_batch)
    loss, grads = _port_value_and_grad(get_model(cfg).train_loss, params,
                                       t_batch)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)
    # the fp32-compute gradients, where the two packages agree to 1e-5
    monkeypatch.setattr(j_tf, "_dtypes",
                        lambda c: JDTypes(compute=jnp.float32))
    monkeypatch.setattr(tf, "_dtypes", lambda c: DTypes(compute=torch.float32))
    j_loss32, j_grads32 = _jax_value_and_grad(
        lambda p, b: j_tf.train_loss(p, b, j_cfg), params, j_batch)
    loss32, grads32 = _port_value_and_grad(
        lambda p, b: tf.train_loss(p, b, cfg), params, t_batch)
    np.testing.assert_allclose(loss32, j_loss32, rtol=1e-5)
    for g, jg in zip(grads32, j_grads32):
        assert _scaled(g, jg) <= 1e-5
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    for path, g, jg, g32 in zip(paths, grads, j_grads, grads32):
        want = jg if _scaled(jg, g32) <= 3e-2 else g32
        assert _scaled(g, want) <= 3e-2, (path, _scaled(g, jg))


def _jax_offloaded(j_cfg, params, j_batch, interval, slots):
    vg = j_api.value_and_grad_offloaded(
        j_get_model(j_cfg).train_loss, interval=interval, slots=slots)
    vg(jax.tree_util.tree_map(jnp.asarray, params), j_batch)
    return j_api.last_plan(), j_api.last_stats(), j_api.last_tune()


@pytest.mark.parametrize("arch,n_layers,interval,slots", [
    ("gemma2-2b", 6, 2, 2),     # 3 periods: an uneven tail segment
    # 5 periods: segments 3 (chunked under checkpoint, s=2) and 2
    ("mamba2-370m", 5, 3, 2),
])
def test_offloaded_gradient_matches_dense_and_jax_plan(arch, n_layers,
                                                       interval, slots):
    j_cfg, cfg, params, j_batch, t_batch = _case(arch, n_layers=n_layers)
    model = get_model(cfg)
    loss, grads = _port_value_and_grad(model.train_loss, params, t_batch)
    vg = api.value_and_grad_offloaded(model.train_loss, interval=interval,
                                      slots=slots, device="cpu")
    v, g = vg(params_from_numpy(params, device="cpu"), t_batch)
    np.testing.assert_allclose(float(v), loss, rtol=1e-5)
    for a, b in zip(pytree.tree_leaves(g), grads):
        assert _scaled(a.numpy(), b) <= 1e-4
    plan, stats, tune = api.last_plan(), api.last_stats(), api.last_tune()
    j_plan, j_stats, j_tune = _jax_offloaded(j_cfg, params, j_batch,
                                             interval, slots)
    assert plan.plan_id == j_plan.plan_id
    assert (tune.interval, tune.slots, tune.n, tune.source) == \
        (j_tune.interval, j_tune.slots, j_tune.n, j_tune.source)
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(j_stats, name), name
    # Level 2 holds bf16 hidden states: 2 bytes per element plus the aux
    B, S, d = SMOKE_SHAPE.global_batch, SMOKE_SHAPE.seq_len, cfg.d_model
    assert stats.l2_peak_bytes % (B * S * d * 2 + 4) == 0


def test_decoder_chain_is_the_period_stack():
    cfg = get_config("gemma2-2b", smoke=True)
    spec = get_model(cfg).train_chain
    assert spec.name == j_get_model(
        j_get_config("gemma2-2b", smoke=True)).train_chain.name
    # one chain step per period: xs are the per-period stacked layers
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    batch = make_batch(cfg, SMOKE_SHAPE, 0, device="cpu")
    _, xs = spec.prelude(params, batch)
    assert sorted(xs) == [f"pos{j}" for j in range(len(cfg.layer_pattern))]
    assert {t.shape[0] for t in pytree.tree_leaves(xs)} == \
        {cfg.n_layers // len(cfg.layer_pattern)}
    for what in ("prefill", "decode", "init_cache"):
        with pytest.raises(NotImplementedError, match="item 14"):
            getattr(get_model(cfg), what)(None, None)


def test_unported_layer_kinds_raise():
    cfg = get_config("gemma2-2b", smoke=True).replace(
        layer_pattern=("attn_moe",), n_layers=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        tf.train_chain(cfg)
