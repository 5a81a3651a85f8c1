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

from _cuda_emu import bits_equal, emulated_libs, kernels_on_card  # noqa: F401

from repro.models import layers as j_layers
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import rope as rope_mod
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


def _bf16(rng, shape, scale=1.0):
    return torch.tensor((rng.standard_normal(shape) * scale)
                        .astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("n_more", [0, 1, 2])
def test_rmsnorm_bwd_fanout_and_skip_bit_for_bit(kernels_on_card, n_more):
    """``rmsnorm_bwd`` with up to two more consumers' cotangents and the
    skip's (bf16, under the emulation): bit for bit the backward of their
    sum as autograd forms it (each add rounded to bf16, in order) with the
    skip's cotangent added to the rounded dx; two calls alike."""
    rng = np.random.default_rng(11)
    x = _bf16(rng, (2, 5, 24))
    scale = torch.tensor(rng.standard_normal(24).astype(np.float32) * 0.1)
    gs = [_bf16(rng, x.shape) for _ in range(1 + n_more)]
    dskip = _bf16(rng, x.shape)
    _, rstd = rn.rmsnorm(x, scale)
    g = gs[0]
    for t in gs[1:]:
        g = g + t
    dx0, ds0 = rn.rmsnorm_bwd(g, x, scale, rstd)
    dx, ds = rn.rmsnorm_bwd(gs[0], x, scale, rstd, g_more=gs[1:],
                            dskip=dskip)
    assert bits_equal(dx, dx0 + dskip) and bits_equal(ds, ds0)
    again = rn.rmsnorm_bwd(gs[0], x, scale, rstd, g_more=gs[1:],
                           dskip=dskip)
    assert bits_equal(again[0], dx) and bits_equal(again[1], ds)
    with pytest.raises(ValueError):
        rn.rmsnorm_bwd(gs[0], x, scale, rstd, g_more=gs * 3)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_rmsnorm_fanout_bit_for_bit(kernels_on_card, n):
    """``layers.rmsnorm_fanout`` on the emulated card against
    ``layers.rmsnorm``'s kernels with the sums made apart: the output and
    the skip, and x's and the scale's gradients, bit for bit those of the
    norm's backward at the consumers' cotangents summed in order (each add
    rounded to bf16; for two, autograd's sum) plus the skip's cotangent
    added to the rounded dx."""
    rng = np.random.default_rng(12)
    x0 = _bf16(rng, (2, 5, 24))
    s0 = torch.tensor(rng.standard_normal(24).astype(np.float32) * 0.1)
    cots = [_bf16(rng, x0.shape) for _ in range(n + 1)]

    x = x0.clone().requires_grad_(True)
    p = {"scale": s0.clone().requires_grad_(True)}
    *ys, skip = layers.rmsnorm_fanout(p, x, n)
    got = (ys[0], skip) + torch.autograd.grad(
        [y * 1 for y in ys] + [skip * 1], (x, p["scale"]), cots)

    x = x0.clone().requires_grad_(True)
    p = {"scale": s0.clone().requires_grad_(True)}
    y = layers.rmsnorm(p, x)
    g = cots[0]
    for c in cots[1:n]:
        g = g + c
    dx, dscale = torch.autograd.grad(y, (x, p["scale"]), g)
    want = (y, x, dx + cots[n], dscale)
    assert all(bits_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_angles_in_the_kernel(kernels_on_card, dtype):
    """The rope kernel with its angles from the position and theta against
    the same kernel on ``layers.rope_table``'s table, forward and backward:
    within a few ulps of the table's sin and cos (fp32), at most one bf16
    rounding apart; the CPU form (``rope_table_plain``) is the table bit for
    bit."""
    S, H, D, theta = 12, 3, 16, 10000.0
    cos, sin = layers.rope_table(S, D, theta)
    pc, ps = rope_mod.rope_table_plain(S, D // 2, theta)
    assert torch.equal(pc, cos) and torch.equal(ps, sin)
    rng = np.random.default_rng(13)
    q = torch.tensor(rng.standard_normal((2, S, H, D))
                     .astype(np.float32)).to(dtype)
    k = torch.tensor(rng.standard_normal((2, S, 1, D))
                     .astype(np.float32)).to(dtype)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for got, want in zip(rope_mod.rope([q, k], None, None, theta=theta),
                         rope_mod.rope([q, k], cos, sin)):
        assert float((got.float() - want.float()).abs().max()) \
            <= tol * float(want.float().abs().max())
    for got, want in zip(rope_mod.rope_bwd([q, k], None, None, theta=theta),
                         rope_mod.rope_bwd([q, k], cos, sin)):
        assert float((got.float() - want.float()).abs().max()) \
            <= tol * float(want.float().abs().max())
    assert isinstance(layers.rope_angles(S, D, theta, like=q),
                      layers.RopeAngles)
