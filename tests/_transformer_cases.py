"""Shared cases of the decoder-family tests (``test_torch_transformer*``):
the port's decoders against the JAX package on the CPU at SMOKE width, with
weights from the JAX package's ``init_lm`` carried over by
``repro_torch.convert`` and batches from both packages' ``make_batch``
(equal tokens).  Tolerances:

* ``train_loss`` against JAX: loss 1e-3 relative, each gradient leaf 3e-2
  of its max |g| (jamba's at the loss only: in bf16 the two packages
  route some of its tokens to other experts).  Both sides compute in bf16 and round in different
  places.  JAX's CPU backend reduces a broadcast bf16 gradient (mamba's
  ``D``) in bf16 and lands farther than that from the fp32-compute
  gradient; a leaf whose JAX gradient is itself more than 3e-2 off the
  fp32-compute one is held against the fp32-compute gradient instead, at
  the same 3e-2, except in the MoE and hybrid models, whose bf16 and fp32
  computations route some tokens to other experts: there each leaf is
  held against the JAX bf16 gradient.  In fp32 compute the two packages
  agree to 1e-5.
* The offloaded gradient (``runner="compiled"``) against the port's own
  dense autograd of ``train_loss``: loss 1e-5 relative, each leaf 1e-4 of
  its max |g|; the plan, the schedule and the executor counters equal the
  JAX package's for the same ``(n, I, s)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTypes
from repro_torch.models.model_factory import get_model

ARCHS = ("gemma2-2b", "mamba2-370m", "qwen1.5-4b", "yi-6b", "granite-3-2b",
         "phi3.5-moe-42b", "llama4-scout-17b-16e", "jamba-v0.1-52b")
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


def _scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch):
    """``train_loss`` and its gradients against the JAX package's, in
    bf16 and fp32 compute."""
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
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    for path, g, jg in zip(paths, grads32, j_grads32):
        # jamba's A_log gradients nearly cancel: the JAX package's own jitted
        # and eager fp32 gradients of this case differ by up to 1.2e-5 of
        # the leaf's max |g| there, so those leaves are held at 3e-5
        tol = 3e-5 if cfg.family == "hybrid" and "A_log" in path else 1e-5
        assert _scaled(g, jg) <= tol, (path, _scaled(g, jg))
    if cfg.family == "hybrid":
        # jamba in bf16: from its second MoE layer on, 1-14 of each MoE
        # layer's 128 top-2 choices go to another expert in one package
        # than in the other (the routers see bf16 hidden states that
        # differ in the last bit), so its bf16 case is held at the loss
        # only; its fp32 gradients above route alike
        return
    for path, g, jg, g32 in zip(paths, grads, j_grads, grads32):
        # a routed model's bf16 gradient is no approximation of its fp32
        # one (the two precisions route some tokens to other experts), so
        # the fallback to the fp32-compute gradient does not apply there
        want = jg if cfg.moe or _scaled(jg, g32) <= 3e-2 else g32
        assert _scaled(g, want) <= 3e-2, (path, _scaled(g, jg))


def _jax_offloaded(j_cfg, params, j_batch, interval, slots):
    vg = j_api.value_and_grad_offloaded(
        j_get_model(j_cfg).train_loss, interval=interval, slots=slots)
    vg(jax.tree_util.tree_map(jnp.asarray, params), j_batch)
    return j_api.last_plan(), j_api.last_stats(), j_api.last_tune()


def check_offloaded_gradient(arch, n_layers, interval, slots):
    """The offloaded gradient (``runner="compiled"``) against the port's
    dense autograd, and its plan, schedule and counters against the JAX
    package's for the same ``(n, I, s)``."""
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
