"""The port's VLM (``internvl2-1b``) and encoder-decoder (``whisper-tiny``)
families against the JAX package, on the CPU at SMOKE width.

Configs equal to the JAX package's; ``make_batch`` equal element for
element (the floats drawn before the tokens, as the JAX package's sorted
leaf walk draws them); weights from the JAX package's ``init`` carried over
by ``convert.params_from_numpy``; ``train_loss`` and its autograd gradient
against ``jax.value_and_grad`` of the JAX package's: the loss within 1e-5
relative and each leaf within 1e-4 of its max |g| in fp32 compute, the loss
within 1e-3 and each leaf within 3e-2 in bf16 (the tolerances of
``tests/_transformer_cases.py``).  ``cross_attention`` against the JAX
package's; serving entry points raise, naming ROADMAP item 14.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as j_encdec
import repro.models.transformer as j_tf
from _transformer_cases import (_case, _jax_value_and_grad,
                                _port_value_and_grad, _scaled)
from repro.configs import base as j_base
from repro.configs.registry import get_config as j_get_config
from repro.configs.shapes import make_batch as j_make_batch
from repro.models.layers import DTypes as JDTypes
from repro.models.model_factory import get_model as j_get_model
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.configs.shapes import make_batch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec, transformer as tf
from repro_torch.models.layers import DTypes
from repro_torch.models.model_factory import get_model

ARCHS = ("internvl2-1b", "whisper-tiny")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(j_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("shape", [("t", 32, 2), ("t", 37, 3),
                                   ("train_4k", 4096, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_equal(arch, shape):
    smoke = shape[0] != "train_4k"
    ours = make_batch(get_config(arch, smoke=smoke),
                      ShapeSpec(*shape, "train"), 5, device="cpu")
    ref = j_make_batch(j_get_config(arch, smoke=smoke),
                       j_base.ShapeSpec(*shape, "train"), 5)
    assert list(ours) == sorted(ref)
    for k, t in ours.items():
        a = np.asarray(ref[k])
        assert tuple(t.shape) == a.shape
        if t.dtype == torch.bfloat16:
            assert str(a.dtype) == "bfloat16"
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("arch", ARCHS)
def test_get_model_builds_and_serving_raises(arch):
    cfg = get_config(arch, smoke=True)
    m = get_model(cfg)
    assert m.train_chain is None
    assert getattr(m.train_loss, "chain_spec", None) is None
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    j_params = j_get_model(j_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0))
    # the same keys and shapes as the JAX package's tree
    ours = jax.tree_util.tree_map(np.shape, params_to_numpy(params))
    assert ours == jax.tree_util.tree_map(np.shape, j_params)
    for what in ("prefill", "decode", "init_cache"):
        with pytest.raises(NotImplementedError, match="item 14"):
            getattr(m, what)(None, None)


@pytest.mark.parametrize("arch,keys", [
    ("internvl2-1b", ("patch_proj",)),
    ("whisper-tiny", ("enc_layers", "dec_layers", "enc_norm")),
])
def test_convert_carries_the_family_leaves(arch, keys):
    """``params_from_numpy`` keeps the families' own subtrees
    (``patch_proj``; ``enc_layers``, ``dec_layers`` with ``xattn``) with
    their values, shapes and layout."""
    _, _, params, _, _ = _case(arch)
    ours = params_from_numpy(params, device="cpu")
    for k in keys:
        assert k in ours
    if arch == "whisper-tiny":
        assert set(ours["dec_layers"]) == {"ln1", "attn", "ln_x", "xattn",
                                           "ln2", "mlp"}
    back = params_to_numpy(ours)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def _fp32(monkeypatch):
    monkeypatch.setattr(j_tf, "_dtypes",
                        lambda c: JDTypes(compute=jnp.float32))
    monkeypatch.setattr(j_encdec, "_dtypes",
                        lambda c: JDTypes(compute=jnp.float32))
    monkeypatch.setattr(tf, "_dtypes", lambda c: DTypes(compute=torch.float32))
    monkeypatch.setattr(encdec, "_dtypes",
                        lambda c: DTypes(compute=torch.float32))


@pytest.mark.parametrize("compute", ["bf16", "fp32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_jax(arch, compute, monkeypatch):
    if compute == "fp32":
        _fp32(monkeypatch)
    j_cfg, cfg, params, j_batch, batch = _case(arch)
    j_loss, j_grads = _jax_value_and_grad(j_get_model(j_cfg).train_loss,
                                          params, j_batch)
    loss, grads = _port_value_and_grad(get_model(cfg).train_loss, params,
                                       batch)
    loss_tol, grad_tol = (1e-5, 1e-4) if compute == "fp32" else (1e-3, 3e-2)
    np.testing.assert_allclose(loss, j_loss, rtol=loss_tol)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    assert len(grads) == len(j_grads) == len(paths)
    for path, g, jg in zip(paths, grads, j_grads):
        assert np.isfinite(g).all(), path
        assert _scaled(g, jg) <= grad_tol, (path, _scaled(g, jg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_cross_attention_matches_jax(heads, dtype):
    """Non-causal attention of 12 decoder positions over 20 encoder
    frames, grouped KV heads included."""
    from repro.models.attention import cross_attention as j_cross
    from repro.models.attention import init_attention as j_init

    H, G = heads
    d, hd, B = 64, 16, 2
    p = jax.tree_util.tree_map(np.asarray, j_init(
        jax.random.PRNGKey(1), d, H, G, hd))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 12, d)).astype(np.float32)
    kv = rng.standard_normal((B, 20, d)).astype(np.float32)
    jdt = JDTypes(compute=jnp.float32 if dtype == torch.float32
                  else jnp.bfloat16)
    ref = np.asarray(j_cross(jax.tree_util.tree_map(jnp.asarray, p),
                             jnp.asarray(x).astype(jdt.compute),
                             jnp.asarray(kv).astype(jdt.compute),
                             n_heads=H, n_kv_heads=G, head_dim=hd,
                             dt=jdt).astype(jnp.float32))
    out = attn_mod.cross_attention(
        params_from_numpy(p, device="cpu"),
        torch.tensor(x).to(dtype), torch.tensor(kv).to(dtype), n_heads=H,
        n_kv_heads=G, head_dim=hd, dt=DTypes(compute=dtype)).float()
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    assert _scaled(out.numpy(), ref) <= tol


def test_encoder_takes_the_chunked_path_over_2048_frames(monkeypatch):
    """The encoder's self-attention is non-causal and, like the decoder's,
    goes through ``chunked_attention`` (the flash kernel on the card) when
    its length is over 2048; at 2048 and below it takes the dense oracle.
    Counted here by wrapping the two paths."""
    calls = []
    real_chunked = attn_mod.chunked_attention
    real_ref = attn_mod.reference_attention

    def chunked(q, k, v, causal=True, *a, **kw):
        calls.append(("chunked", causal))
        return real_chunked(q, k, v, causal, *a, **kw)

    def dense_(q, k, v, causal=True, *a, **kw):
        calls.append(("dense", causal))
        return real_ref(q, k, v, causal, *a, **kw)

    monkeypatch.setattr(attn_mod, "chunked_attention", chunked)
    monkeypatch.setattr(attn_mod, "reference_attention", dense_)
    cfg = get_config("whisper-tiny", smoke=True).replace(n_enc_layers=1)
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    for frames, want in ((2050, ("chunked", False)),
                         (2048, ("dense", False))):
        calls.clear()
        x = torch.zeros((1, frames, cfg.d_model), dtype=torch.bfloat16)
        with torch.no_grad():
            out = encdec.encode(params, x, cfg)
        assert calls == [want]
        assert tuple(out.shape) == (1, frames, cfg.d_model)
