"""The port's paper model (§5 LSTM), config, batch and optimizer against the
JAX package's, on the CPU at a small size.

Weights are drawn once with numpy and pushed into both packages through
``params_from_numpy``.  Tolerances: the loss within 1e-5 and gradients
within 1e-4 (fp32 on both sides, different summation orders); RMSProp
parameters within 1e-5 after three steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs.registry import get_config as j_get_config
from repro.configs.shapes import make_batch as j_make_batch
from repro.models import lstm as j_lstm
from repro.models.model_factory import get_model as j_get_model
from repro.optim.optimizers import rmsprop as j_rmsprop
from repro_torch.configs import SHAPES, SMOKE_SHAPE, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.shapes import make_batch
from repro_torch.convert import (init_lstm_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.models import lstm
from repro_torch.models.model_factory import get_model
from repro_torch.optim import rmsprop

V, DX, DH, B, T = 17, 8, 16, 4, 37


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T + 1)).astype(
        np.int32)


def _both_params(seed=0):
    ref = init_lstm_numpy(seed, V, DX, DH)
    return ({k: jnp.asarray(v) for k, v in ref.items()},
            params_from_numpy(ref, device="cpu"))


@pytest.mark.parametrize("smoke", [False, True])
def test_lstm_config_fields_equal(smoke):
    assert dataclasses.asdict(get_config("lstm-paper", smoke=smoke)) == \
        dataclasses.asdict(j_get_config("lstm-paper", smoke=smoke))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    assert dataclasses.asdict(SMOKE_SHAPE) == \
        dataclasses.asdict(j_base.SMOKE_SHAPE)


def test_other_archs_not_ported_yet():
    """Every architecture of the JAX package's registry loads (the VLM and
    the encoder-decoder were the last ones not ported), and an unknown one
    raises ``KeyError`` as there."""
    from repro.configs.registry import _MODULES as J_MODULES

    for name in J_MODULES:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))
    for name in ("internvl2-1b", "whisper-tiny"):
        assert get_config(name, smoke=True).family in ("vlm", "encdec")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("shape", [SMOKE_SHAPE,
                                   ShapeSpec("t", 37, 4, "train"),
                                   SHAPES["train_4k"]])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_tokens_identical(shape, seed):
    cfg = get_config("lstm-paper")
    j_shape = j_base.ShapeSpec(shape.name, shape.seq_len, shape.global_batch,
                               shape.kind)
    ours = make_batch(cfg, shape, seed, device="cpu")["tokens"]
    ref = np.asarray(j_make_batch(j_get_config("lstm-paper"), j_shape,
                                  seed)["tokens"])
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_params_roundtrip_keeps_layout():
    ref = init_lstm_numpy(3, V, DX, DH)
    back = params_to_numpy(params_from_numpy(ref, device="cpu"))
    assert set(back) == {"emb", "w", "b", "w_out", "b_out"}
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])
    assert back["w"].shape == (DX + DH, 4 * DH)


def test_init_lstm_shapes_and_scales():
    p = lstm.init_lstm(torch.Generator().manual_seed(0), V, DX, DH,
                       device="cpu")
    jp = j_lstm.init_lstm(jax.random.PRNGKey(0), V, DX, DH)
    for k in jp:
        assert tuple(p[k].shape) == tuple(jp[k].shape)
        assert p[k].dtype == torch.float32
    assert float(p["b"].abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_loss_and_grads_match_jax(seed):
    jp, tp = _both_params(seed)
    tok = _tokens(seed)
    j_loss, j_grads = jax.value_and_grad(j_lstm.forward_loss)(
        jp, jnp.asarray(tok))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = lstm.forward_loss(leaves, torch.as_tensor(tok))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[k]),
                                   rtol=1e-4, atol=1e-4 * float(
                                       np.abs(j_grads[k]).max()), err_msg=k)


def test_model_factory_train_loss_is_a_chain():
    cfg = get_config("lstm-paper", smoke=True)
    model = get_model(cfg)
    assert model.train_loss.chain_spec is model.train_chain
    assert model.train_chain.name == \
        j_get_model(j_get_config("lstm-paper", smoke=True)).train_chain.name
    jp, tp = _both_params()
    tok = _tokens()
    ours = model.train_loss(tp, {"tokens": torch.as_tensor(tok)})
    ref = j_get_model(j_get_config("lstm-paper", smoke=True)).train_loss(
        jp, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)
    spec_loss = model.train_chain.loss_fn()(tp, {"tokens":
                                                 torch.as_tensor(tok)})
    np.testing.assert_allclose(float(spec_loss), float(ref), rtol=1e-5)


def test_rmsprop_three_steps_match_jax():
    jp, tp = _both_params(5)
    tok = _tokens(5)
    j_opt, t_opt = j_rmsprop(1e-2), rmsprop(1e-2)
    j_state, t_state = j_opt.init(jp), t_opt.init(tp)
    j_vg = jax.value_and_grad(j_lstm.forward_loss)
    for step in range(3):
        _, j_g = j_vg(jp, jnp.asarray(tok))
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        loss = lstm.forward_loss(leaves, torch.as_tensor(tok))
        t_g = dict(zip(leaves, torch.autograd.grad(loss,
                                                   list(leaves.values()))))
        jp, j_state = j_opt.update(j_g, j_state, jp, jnp.asarray(step))
        tp, t_state = t_opt.update(t_g, t_state, tp, step)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No silent CPU fallback: without a card, entry points that were not
    given device='cpu' raise."""
    from repro_torch.api import value_and_grad_offloaded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("lstm-paper", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(cfg, SMOKE_SHAPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(init_lstm_numpy(0, V, DX, DH))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        value_and_grad_offloaded(get_model(cfg).train_loss)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lstm.init_lstm(torch.Generator(), V, DX, DH)
