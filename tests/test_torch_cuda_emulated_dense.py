"""The projection GEMM's CUDA source (``csrc/dense.cu``) run on the CPU under
the emulation of ``tests/_cuda_emu.py`` through its wrappers' card paths,
against the plain versions (``x @ w.to(x.dtype)`` and its autograd vjp):
``dense_fwd`` and ``dense_bwd`` (dx and dw) at ragged shapes -- M, K and N
not multiples of any tile, N one 128-column tile and a 32-column remainder
(mamba2-370m's ``in_proj`` N = 4384 is 34 tiles and 32), row strides and
widths that force the element loads, a strided view of x -- with x in bf16
(the tensor cores) and fp32 (the SIMT product) and w in fp32 (cast in the
load) and bf16.  Each output within the repo's scaled tolerance of the
plain version's max |value| (fp32 2e-4, bf16 3e-2), dw in w's dtype and,
for bf16 x, a bf16 value; two calls bit for bit.  Then ``layers.dense``
through the autograd function (a bias, dw skipped where w needs no
gradient), and the refusals.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import dense as dn
from repro_torch.models import layers

F32, BF16 = torch.float32, torch.bfloat16


def _t(rng, shape, dtype=F32, scale=1.0):
    return torch.tensor(_np(rng, shape, scale)).to(dtype)


@pytest.mark.parametrize("M,K,N,x_dt,w_dt,pad", [
    (77, 72, 37, BF16, F32, 0),     # N odd: element loads of w and dy
    (130, 40, 160, BF16, F32, 0),   # 16-byte loads; N = 128 + 32
    (50, 100, 24, BF16, BF16, 0),   # K % 8 = 4: element loads of x
    (70, 48, 160, BF16, BF16, 8),   # x a strided view (row stride 56)
    (300, 264, 40, BF16, F32, 0),   # two 256-row tiles each way
    (77, 72, 37, F32, F32, 0),      # the SIMT fp32 product
    (33, 20, 40, F32, BF16, 3),
])
def test_dense_kernel_source(kernels_on_card, M, K, N, x_dt, w_dt, pad):
    rng = np.random.default_rng(M * K + N)
    x = _t(rng, (M, K + pad), x_dt)[:, :K]
    w = _t(rng, (K, N), F32, K ** -0.5).to(w_dt)
    dy = _t(rng, (M, N), x_dt)
    before = (dn.dense_fwd.launches, dn.dense_bwd.launches)
    y = dn.dense_fwd(x, w)
    dx, dw = dn.dense_bwd(dy, x, w)
    assert (dn.dense_fwd.launches, dn.dense_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_y = dn.dense_fwd_plain(x, w)
    want_dx, want_dw = dn.dense_bwd_plain(dy, x, w)
    tol = 3e-2 if x_dt == BF16 else 2e-4
    assert y.dtype == x_dt and dx.dtype == x_dt and dw.dtype == w_dt
    assert y.shape == (M, N) and dx.shape == (M, K) and dw.shape == (K, N)
    for got, want in ((y, want_y), (dx, want_dx), (dw, want_dw)):
        assert scaled_err(got, want) <= tol
    if x_dt == BF16:   # rounded to bf16 before it is written in w's dtype
        assert bits_equal(dw.to(BF16).to(w_dt), dw)
    assert bits_equal(y, dn.dense_fwd(x, w))
    assert all(bits_equal(a, b) for a, b in zip(
        (dx, dw), dn.dense_bwd(dy, x, w)))


@pytest.mark.parametrize("x_dt", [F32, BF16])
def test_layers_dense_through_the_kernels(kernels_on_card, monkeypatch,
                                         x_dt):
    rng = np.random.default_rng(7)
    p = {"w": _t(rng, (24, 40), F32, 0.2).requires_grad_(True),
         "b": _t(rng, (40,), F32, 0.1).requires_grad_(True)}
    x = _t(rng, (2, 5, 24), x_dt).requires_grad_(True)
    g = _t(rng, (2, 5, 40), x_dt)
    dt = layers.DTypes(compute=x_dt)
    before = (dn.dense_fwd.launches, dn.dense_bwd.launches)
    y = layers.dense(p, x, dt)
    grads = torch.autograd.grad(y, (x, p["w"], p["b"]), g)
    assert (dn.dense_fwd.launches, dn.dense_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, p["w"],
                                                            p["b"])]
        want = leaves[0] @ leaves[1].to(x_dt) + leaves[2].to(x_dt)
        want_grads = torch.autograd.grad(want, leaves, g)
    tol = 3e-2 if x_dt == BF16 else 2e-4
    assert scaled_err(y, want) <= tol
    for a, b in zip(grads, want_grads):
        assert a.dtype == b.dtype and scaled_err(a, b) <= tol
    # w frozen: the backward skips dw
    seen = {}
    real = dn.dense_bwd

    def spy(dy, x, w, **kw):
        seen.update(kw)
        return real(dy, x, w, **kw)

    spy.launches = 0   # the wrapper counts under its module name
    monkeypatch.setattr(dn, "dense_bwd", spy)
    y = layers.dense({"w": p["w"].detach()}, x, dt)
    (dx,) = torch.autograd.grad(y, (x,), g)
    assert seen == {"need_dx": True, "need_dw": False}
    assert scaled_err(dx, want_grads[0]) <= tol


def test_dense_refuses(kernels_on_card):
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="float64"):
        dn.dense_fwd(x.double(), torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="w must be"):
        dn.dense_fwd(x, torch.zeros((7, 3)))
    with pytest.raises(ValueError, match="dy"):
        dn.dense_bwd(torch.zeros((4, 3), dtype=BF16), x, torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="compute dtype"):
        dn.project(x, torch.zeros((8, 3)), BF16)
