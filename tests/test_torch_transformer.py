"""The port's decoder families against the JAX package, on the CPU at SMOKE
width (cases and tolerances: ``tests/_transformer_cases.py``).  This file
holds what every family shares (configs, batches and parameter trees, the
port's own init and autograd, the chain's period stack, the kinds left to
port) and the dense family (``gemma2-2b``, ``qwen1.5-4b``; ``yi-6b`` and
``granite-3-2b`` in the shared cases); the SSM, MoE and hybrid families
have files of their own (``test_torch_transformer_{ssm,moe,hybrid}.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch
from _transformer_cases import (ARCHS, _case, _port_value_and_grad,
                                check_offloaded_gradient,
                                check_train_loss_matches_jax)
from torch.utils import _pytree as pytree

from repro.configs.registry import get_config as j_get_config
from repro.models.model_factory import get_model as j_get_model
from repro_torch.configs import SMOKE_SHAPE, get_config
from repro_torch.configs.shapes import make_batch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import transformer as tf
from repro_torch.models.model_factory import get_model


def _shapes(tree, prefix=""):
    """{"a/b/c": shape} of a nested dict (key order aside)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}



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
    # S > 2048: the chunked attention path (its plain forward and the
    # flash-style backward) at one period of the local/global pattern, over
    # three KV chunks
    ("gemma2-2b", 2064, 1, {"attn_chunk": 688}),
    ("qwen1.5-4b", None, None, {}),        # QKV bias
])
def test_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch):
    check_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch)


@pytest.mark.parametrize("arch,n_layers,interval,slots", [
    ("gemma2-2b", 6, 2, 2),     # 3 periods: an uneven tail segment
])
def test_offloaded_gradient_matches_dense_and_jax_plan(arch, n_layers,
                                                       interval, slots):
    check_offloaded_gradient(arch, n_layers, interval, slots)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_decoder_builds_and_differentiates(arch):
    """The port's own init, batch and autograd at SMOKE width: a finite
    loss and a finite gradient for every parameter leaf."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    loss, grads = _port_value_and_grad(
        model.train_loss, params_to_numpy(params),
        make_batch(cfg, SMOKE_SHAPE, 0, device="cpu"))
    assert np.isfinite(loss)
    assert len(grads) == len(pytree.tree_leaves(params))
    assert all(np.isfinite(g).all() for g in grads)


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
    """Every family of the JAX package builds in ``get_model`` (the VLM and
    the encoder-decoder were the last ones), with the JAX package's
    ``train_chain`` (none for those two); every layer kind of the JAX
    package is ported, and an unknown one raises."""
    for arch, family in (("internvl2-1b", "vlm"),
                         ("whisper-tiny", "encdec")):
        cfg = get_config(arch, smoke=True)
        assert cfg.family == family
        m = get_model(cfg)
        assert m.train_chain is None
        assert j_get_model(j_get_config(arch, smoke=True)).train_chain \
            is None
        assert callable(m.train_loss) and callable(m.init)
    assert set(tf.KINDS) == {"attn", "attn_local", "attn_moe", "mamba",
                             "mamba_moe"}
    with pytest.raises(ValueError, match="unknown layer kind"):
        tf.train_chain(get_config("gemma2-2b", smoke=True).replace(
            layer_pattern=("attn_dense",)))
