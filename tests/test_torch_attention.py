"""The port's attention against the JAX package, on the CPU.

* The flash-attention kernel's plain version (``kernels.flash_attention``
  on CPU tensors, i.e. ``flash_attention_ref`` over the flattened heads)
  and the chunked forward ``_chunked_fwd`` against the Pallas kernel run in
  interpret mode, at the cases of ``tests/test_kernels.py``
  (``test_flash_attention_shapes``, ``test_flash_attention_features``).
  Tolerance 2e-4 in fp32, 3e-2 in bf16.
* ``chunked_attention``'s value and gradients (its hand-written backward)
  against JAX's custom VJP, with window, softcap and ``Sq < Sk``: 2e-4 in
  fp32.
* On a CUDA tensor the kernel wrapper launches or raises: a failed build
  is an error, never the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.models import attention as j_attn
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn


def _qkv(seed, B, Sq, Sk, H, G, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D))]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,H,G,D,bq,bk", [
    (128, 4, 4, 32, 64, 64),      # MHA
    (256, 8, 2, 64, 64, 128),     # GQA, rectangular blocks
    (64, 2, 1, 128, 64, 64),      # MQA, big head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_versions_match_pallas(S, H, G, D, bq, bk, dtype):
    arrs = _qkv(S + D, 2, S, S, H, G, D)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    q, k, v = (torch.tensor(a).to(getattr(torch, dtype)) for a in arrs)
    want = j_ops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                 interpret=True)
    tol = 2e-4 if dtype == "float32" else 3e-2
    _close(fa.flash_attention(q, k, v).float(), want, tol)
    out, lse = attn._chunked_fwd(q, k, v, True, None, None, bk, None)
    _close(out.float(), want, tol)
    assert lse.shape == (2, G, H // G, S) and lse.dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(window=64), dict(softcap=30.0), dict(causal=False),
    dict(window=32, softcap=15.0),
])
def test_flash_plain_features_match_pallas(kw):
    arrs = _qkv(4, 1, 128, 128, 4, 2, 32)
    want = j_ops.flash_attention(*map(jnp.asarray, arrs), block_q=32,
                                 block_k=32, interpret=True, **kw)
    q, k, v = map(torch.tensor, arrs)
    _close(fa.flash_attention(q, k, v, **kw), want, 2e-4)
    out, _ = attn._chunked_fwd(q, k, v, kw.get("causal", True),
                               kw.get("window"), kw.get("softcap"), 32, None)
    _close(out, want, 2e-4)


@pytest.mark.parametrize("Sq,Sk,kw", [
    (64, 64, dict()),
    (48, 96, dict(window=40, softcap=20.0)),   # queries end the keys
    (64, 64, dict(causal=False, scale=0.2)),
])
def test_chunked_attention_value_and_grads_match_jax(Sq, Sk, kw):
    B, H, G, D, chunk = 2, 4, 2, 16, 16
    arrs = _qkv(Sq + Sk, B, Sq, Sk, H, G, D)
    dout = np.random.default_rng(1).standard_normal(
        (B, Sq, H, D)).astype(np.float32)
    args = (kw.get("causal", True), kw.get("window"), kw.get("softcap"),
            chunk, kw.get("scale"))

    def j_loss(q, k, v):
        return jnp.sum(j_attn.chunked_attention(q, k, v, *args) * dout)

    j_val, j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, arrs))
    q, k, v = (torch.tensor(a).requires_grad_(True) for a in arrs)
    out = attn.chunked_attention(q, k, v, *args)
    val = torch.sum(out * torch.tensor(dout))
    grads = torch.autograd.grad(val, (q, k, v))
    _close(val.detach(), j_val, 2e-4 * max(1.0, abs(float(j_val))))
    for g, jg in zip(grads, j_grads):
        _close(g, jg, 2e-4)
    # the dense oracle agrees too
    ref = attn.reference_attention(q, k, v, args[0], args[1], args[2],
                                   args[4])
    _close(ref.detach(), out.detach(), 2e-4)
    _close(ref.detach(), j_attn.reference_attention(
        *map(jnp.asarray, arrs), args[0], args[1], args[2], args[4]), 2e-4)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that claims to be on the card: the wrapper must then
    take the kernel's path, whatever the build does."""

    @property
    def is_cuda(self):
        return True


def test_failed_build_raises_instead_of_falling_back(monkeypatch):
    def no_build(name):
        raise RuntimeError(f"CUDA kernel build failed ({name})")

    monkeypatch.setattr(build, "load", no_build)
    q, k, v = (torch.tensor(a).as_subclass(_OnTheCard)
               for a in _qkv(0, 1, 8, 8, 2, 1, 16))
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="build failed"):
        fa.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="build failed"):
        attn.chunked_attention(q, k, v)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("kw", [dict(window=24, softcap=50.0),
                                dict(causal=False)])
def test_chunked_attention_bf16_grads_match_jax(kw):
    """The plain backward ``_chunked_bwd`` in bf16 (p and dS rounded to
    bf16 before their products, as in the JAX package) against JAX's
    custom VJP: each gradient within 3e-2 of its max |value|."""
    B, Sq, Sk, H, G, D, chunk = 2, 40, 56, 4, 2, 32, 8
    arrs = _qkv(9, B, Sq, Sk, H, G, D)
    dout = np.random.default_rng(2).standard_normal(
        (B, Sq, H, D)).astype(np.float32)
    args = (kw.get("causal", True), kw.get("window"), kw.get("softcap"),
            chunk, None)

    def j_loss(q, k, v):
        o = j_attn.chunked_attention(q, k, v, *args)
        return jnp.sum(o.astype(jnp.float32) * dout)

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    q, k, v = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
               for a in arrs)
    out = attn.chunked_attention(q, k, v, *args)
    grads = torch.autograd.grad(torch.sum(out.float() * torch.tensor(dout)),
                                (q, k, v))
    for g, jg in zip(grads, j_grads):
        assert g.dtype == torch.bfloat16
        jg = np.asarray(jg, np.float32)
        err = np.abs(g.float().numpy() - jg).max() / np.abs(jg).max()
        assert err <= 3e-2, err
