"""The plain versions of the layer kernels (``kernels/rmsnorm.py``,
``glu.py``, ``rope.py``: the autograd functions ``layers.rmsnorm``,
``geglu``/``swiglu`` and ``apply_rope`` run on the CPU) against the JAX
package's ``layers`` functions through ``jax.vjp``, on the same
numpy-seeded inputs and cotangents: values and every input's cotangent
within 1e-5 (fp32) or 3e-2 (bf16) of the JAX value's max |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro_torch.models import layers

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _vjp_both(j_fn, t_fn, arrays, dtypes, cot, tol):
    """Values and cotangents of ``j_fn`` (JAX) and ``t_fn`` (the port) on
    ``arrays`` cast to ``dtypes`` (torch, jax pairs), for the cotangent
    ``cot`` of the output."""
    j_in = [jnp.asarray(a, jd) for a, (_, jd) in zip(arrays, dtypes)]
    j_out, vjp = jax.vjp(j_fn, *j_in)
    j_grads = vjp(jnp.asarray(cot, j_out.dtype))
    t_in = [torch.tensor(a).to(td).requires_grad_(True)
            for a, (td, _) in zip(arrays, dtypes)]
    t_out = t_fn(*t_in)
    assert str(t_out.dtype).split(".")[-1] == str(j_out.dtype)
    grads = torch.autograd.grad(t_out, t_in,
                                torch.tensor(cot).to(t_out.dtype))
    _close(t_out, j_out, tol)
    for g, jg, t in zip(grads, j_grads, t_in):
        assert g.dtype == t.dtype
        _close(g, jg, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_matches_jax(dtype, residual):
    td, jd, tol = DTYPES[dtype]
    B, S, d = 2, 5, 48
    x, scale, res, cot = _arrays(3, (B, S, d), (d,), (B, S, d), (B, S, d))
    scale = scale * 0.3
    j_dt = j_layers.DTypes(compute=jd)
    t_dt = layers.DTypes(compute=td)
    if residual:
        def j_fn(x, s, r):
            return r + j_layers.rmsnorm({"scale": s}, x, dt=j_dt)

        def t_fn(x, s, r):
            return layers.rmsnorm({"scale": s}, x, dt=t_dt, residual=r)
        arrays, dts = [x, scale, res], [(td, jd), (torch.float32,
                                                   jnp.float32), (td, jd)]
    else:
        def j_fn(x, s):
            return j_layers.rmsnorm({"scale": s}, x, dt=j_dt)

        def t_fn(x, s):
            return layers.rmsnorm({"scale": s}, x, dt=t_dt)
        arrays, dts = [x, scale], [(td, jd), (torch.float32, jnp.float32)]
    _vjp_both(j_fn, t_fn, arrays, dts, cot, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ["geglu", "swiglu"])
def test_glu_matches_jax(dtype, act):
    td, jd, tol = DTYPES[dtype]
    gate, up, cot = _arrays(5, (2, 7, 96), (2, 7, 96), (2, 7, 96), scale=2.0)
    _vjp_both(getattr(j_layers, act), getattr(layers, act), [gate, up],
              [(td, jd)] * 2, cot, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope_matches_jax(dtype):
    td, jd, tol = DTYPES[dtype]
    B, S, H, D = 2, 9, 3, 32
    x, cot = _arrays(7, (B, S, H, D), (B, S, H, D))
    j_cos, j_sin = j_layers.rope_table(S, D)
    cos, sin = layers.rope_table(S, D, device="cpu")
    np.testing.assert_allclose(cos.numpy(), np.asarray(j_cos), rtol=1e-6,
                               atol=1e-6)
    _vjp_both(lambda x: j_layers.apply_rope(x, j_cos, j_sin),
              lambda x: layers.apply_rope(x, cos, sin), [x], [(td, jd)],
              cot, tol)
    # q and k in one call: each as on its own
    q, k = (torch.tensor(a).to(td) for a in _arrays(8, (B, S, H, D),
                                                    (B, S, 1, D)))
    qq, kk = layers.apply_rope_qk(q, k, cos, sin)
    assert torch.equal(qq, layers.apply_rope(q, cos, sin))
    assert torch.equal(kk, layers.apply_rope(k, cos, sin))
