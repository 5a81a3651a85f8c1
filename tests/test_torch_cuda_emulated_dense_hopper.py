"""The projection GEMM's Hopper form (``csrc/dense.cu::dense_wgmma_kernel``:
a persistent grid, a TMA-fed ring, wgmma consumer warpgroups) under the
emulation of ``tests/_cuda_emu.py`` (an emulated card of 4 SMs), through
its wrappers' card paths against the plain versions: ragged M, K and N
(tiles of 128 x 256 and stages of 64 all cut at the edges), the fp32 weight
read as the register operand (rounded in registers) or rounded into a
per-call bf16 copy, and a bf16 weight read as it is, the residual
epilogue, dw split over M into fp32 partials and summed in a
second pass (twice bit for bit, and the same values as one slice would
give within the tolerance), the experts' batched products, and the choice
of form by layout: aligned operands never take the ``mma.sync`` form, an
operand TMA cannot read always does (and counts apart).
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import dense as dn

F32, BF16 = torch.float32, torch.bfloat16


def _t(rng, shape, dtype=F32, scale=1.0):
    return torch.tensor(_np(rng, shape, scale)).to(dtype)


def _mma(*fns):
    return [fn.mma_sync for fn in fns]


@pytest.mark.parametrize("M,K,N,w_dt", [
    (300, 200, 520, F32),    # three row tiles, N = 2 x 256 + 8
    (130, 72, 264, BF16),    # a bf16 weight read as it is; ragged R stage
    (64, 8, 16, F32),        # one short stage, one narrow tile
])
@pytest.mark.parametrize("w32_rows", [dn.W32_ROWS, 0])
def test_hopper_form_ragged(kernels_on_card, monkeypatch, M, K, N, w_dt,
                            w32_rows):
    """An fp32 weight as the register operand (fewer rows than
    ``W32_ROWS``) and rounded into its per-call bf16 copy (0)."""
    monkeypatch.setattr(dn, "W32_ROWS", w32_rows)
    rng = np.random.default_rng(M + K + N)
    x = _t(rng, (M, K), BF16)
    w = _t(rng, (K, N), F32, K ** -0.5).to(w_dt)
    dy = _t(rng, (M, N), BF16)
    res = _t(rng, (M, N), BF16)
    before = _mma(dn.dense_fwd, dn.dense_bwd)
    y = dn.dense_fwd(x, w)
    yr = dn.dense_fwd(x, w, res)
    dx, dw = dn.dense_bwd(dy, x, w)
    assert _mma(dn.dense_fwd, dn.dense_bwd) == before
    want_y = dn.dense_fwd_plain(x, w)
    want_dx, want_dw = dn.dense_bwd_plain(dy, x, w)
    assert dw.dtype == w_dt and y.dtype == BF16
    for got, want in ((y, want_y), (dx, want_dx), (dw, want_dw)):
        assert scaled_err(got, want) <= 3e-2
    # the residual epilogue: the product rounded, then the add rounded
    assert bits_equal(yr, (res.float() + y.float()).to(BF16))
    assert bits_equal(dw.to(BF16).to(w_dt), dw)
    assert bits_equal(y, dn.dense_fwd(x, w))


def test_dw_split_over_m(kernels_on_card):
    """dw's reduction over M in 4 slices on the emulated 4-SM card (one
    output tile): the partials' sum in index order, rounded once."""
    M, K, N = 2048, 64, 72
    rng = np.random.default_rng(11)
    x = _t(rng, (M, K), BF16)
    w = _t(rng, (K, N), F32, K ** -0.5)
    dy = _t(rng, (M, N), BF16)
    assert dn._lib().dense_dw_slices(M, K, N, 1) == 4
    _, dw = dn.dense_bwd(dy, x, w, need_dx=False)
    _, again = dn.dense_bwd(dy, x, w, need_dx=False)
    assert bits_equal(dw, again)
    want = dn.dense_bwd_plain(dy, x, w)[1]
    assert scaled_err(dw, want) <= 3e-2
    # one slice (the tiles fill the card) gives the same values within the
    # rounding of one bf16 ulp
    ref = x.float().T @ dy.float()
    assert scaled_err(dw, ref) <= 1e-2


def test_experts_batched(kernels_on_card):
    E, M, K, N = 3, 100, 72, 136
    rng = np.random.default_rng(5)
    x = _t(rng, (E, M, K), BF16)
    w = _t(rng, (E, K, N), F32, K ** -0.5)
    dy = _t(rng, (E, M, N), BF16)
    before = _mma(dn.expert_fwd, dn.expert_bwd)
    y = dn.expert_fwd(x, w)
    dx, dw = dn.expert_bwd(dy, x, w)
    assert _mma(dn.expert_fwd, dn.expert_bwd) == before
    want = (dn.expert_fwd_plain(x, w), *dn.expert_bwd_plain(dy, x, w))
    for got, ref in zip((y, dx, dw), want):
        assert got.dtype == ref.dtype and scaled_err(got, ref) <= 3e-2
    assert all(bits_equal(a, b) for a, b in zip(
        (dx, dw), dn.expert_bwd(dy, x, w)))


def test_unaligned_operands_take_the_mma_sync_form(kernels_on_card):
    """K = 100: x's rows are 200 bytes, which TMA cannot step; the forward
    and dw take the mma.sync form (counted), dx (dy and w aligned) the
    Hopper form."""
    M, K, N = 40, 100, 24
    rng = np.random.default_rng(9)
    x = _t(rng, (M, K), BF16)
    w = _t(rng, (K, N), F32, K ** -0.5)
    dy = _t(rng, (M, N), BF16)
    f0, b0 = _mma(dn.dense_fwd, dn.dense_bwd)
    y = dn.dense_fwd(x, w)
    dx, dw = dn.dense_bwd(dy, x, w)
    assert _mma(dn.dense_fwd, dn.dense_bwd) == [f0 + 1, b0 + 1]
    want = (dn.dense_fwd_plain(x, w), *dn.dense_bwd_plain(dy, x, w))
    for got, ref in zip((y, dx, dw), want):
        assert scaled_err(got, ref) <= 3e-2
