"""The port's projection ``layers.dense`` against the JAX package's
``repro.models.layers.dense`` through ``jax.vjp``, on the same numpy-seeded
inputs, weights and cotangents, in fp32 and bf16 compute, with and without
a bias: the output, dx, the fp32 dw (and db) within 1e-5 (fp32) or 3e-2
(bf16) of the JAX value's max |value|.  On the CPU the port computes
``x @ w.to(compute)`` under autograd (the kernels' plain version); the
routing case patches ``build.on_card`` (the emulated kernel of
``tests/_cuda_emu.py``) so that ``layers.dense`` takes the autograd function
``_Dense``, counted in ``dense_fwd.launches`` and ``dense_bwd.launches``,
and holds it to the same JAX values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _cuda_emu import emulated_libs, kernels_on_card  # noqa: F401

from repro.models import layers as j_layers
from repro_torch.kernels import dense as dn
from repro_torch.models import layers

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}
B, S, K, N = 2, 7, 48, 40


def _case(seed, bias):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    p = {"w": (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)}
    if bias:
        p["b"] = (rng.standard_normal((N,)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, p, cot


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _against_jax(dtype, bias, seed):
    td, jd, tol = DTYPES[dtype]
    x, p, cot = _case(seed, bias)
    j_dt = j_layers.DTypes(compute=jd)
    j_p = {k: jnp.asarray(v) for k, v in p.items()}
    j_y, vjp = jax.vjp(lambda x, p: j_layers.dense(p, x, j_dt),
                       jnp.asarray(x, jd), j_p)
    j_dx, j_dp = vjp(jnp.asarray(cot, j_y.dtype))

    t_x = torch.tensor(x).to(td).requires_grad_(True)
    t_p = {k: torch.tensor(v).requires_grad_(True) for k, v in p.items()}
    y = layers.dense(t_p, t_x, layers.DTypes(compute=td))
    assert str(y.dtype).split(".")[-1] == str(j_y.dtype)
    names = sorted(t_p)
    grads = torch.autograd.grad(y, [t_x] + [t_p[k] for k in names],
                                torch.tensor(cot).to(y.dtype))
    _close(y, j_y, tol)
    _close(grads[0], j_dx, tol)
    assert grads[0].dtype == td
    for k, g in zip(names, grads[1:]):
        assert g.dtype == torch.float32   # the parameters' own dtype
        _close(g, j_dp[k], tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_jax(dtype, bias):
    _against_jax(dtype, bias, seed=11)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_routes_through_the_kernels(kernels_on_card, dtype):
    before = (dn.dense_fwd.launches, dn.dense_bwd.launches)
    _against_jax(dtype, True, seed=12)
    assert (dn.dense_fwd.launches, dn.dense_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_residual_epilogue_bit_for_bit(kernels_on_card, dtype):
    """The forward kernel's residual epilogue (a pre-norm layer's skip) is
    the product rounded, then ``residual + y`` rounded again: bit for bit
    the kernel's own product plus PyTorch's add, two calls alike; through
    ``layers.dense(..., residual=)`` the residual's cotangent is ``dy`` and
    x's and w's are those of the product without it."""
    tdt = DTYPES[dtype][0]
    x, p, cot = _case(5, False)
    x, cot = torch.tensor(x).to(tdt), torch.tensor(cot).to(tdt)
    w = torch.tensor(p["w"])
    res = torch.tensor(np.random.default_rng(6).standard_normal(
        (B, S, N)).astype(np.float32)).to(tdt)
    got = dn.dense_fwd(x, w, res)
    assert torch.equal(got.view(torch.int16) if tdt == torch.bfloat16
                       else got, (res + dn.dense_fwd(x, w)).view(
                           torch.int16) if tdt == torch.bfloat16
                       else res + dn.dense_fwd(x, w))
    assert torch.equal(got, dn.dense_fwd(x, w, res))
    with pytest.raises(ValueError):
        dn.dense_fwd(x, w, res.transpose(0, 1).contiguous().transpose(0, 1))

    def grads(with_res):
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        rr = res.clone().requires_grad_(True)
        dt = layers.DTypes(compute=tdt)
        y = (layers.dense({"w": wr}, xr, dt, residual=rr) if with_res
             else layers.dense({"w": wr}, xr, dt))
        return torch.autograd.grad(y, (xr, wr, rr) if with_res else (xr, wr),
                                   cot)

    (dx, dw, dres), (dx0, dw0) = grads(True), grads(False)
    assert torch.equal(dres, cot)
    assert torch.equal(dx, dx0) and torch.equal(dw, dw0)
