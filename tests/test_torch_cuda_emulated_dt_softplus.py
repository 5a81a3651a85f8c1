"""The step sizes' CUDA source (``csrc/dt_softplus.cu``: Mamba-2's
``softplus(dt_raw + dt_bias)`` in fp32) run on the CPU under the emulation
of ``tests/_cuda_emu.py`` through its wrapper's card path, against its
plain version: the output and both cotangents within 1e-6 (fp32) of the
plain version's max |value|, the bf16 input's cotangent within one bf16
rounding (3e-2), dt_raw a column slice of wider rows, inputs past
softplus' linear threshold (20); the same bits on two calls.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import dt_softplus as ds

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("B,T,H,dtype,wide", [
    (2, 40, 8, F32, 5),
    (1, 300, 3, BF16, 0),    # rows over one block's stride
])
def test_dt_softplus_kernel_source(kernels_on_card, B, T, H, dtype, wide):
    rng = np.random.default_rng(T + H)
    raw = torch.tensor(_np(rng, (B, T, H + wide), 8.0)).to(dtype)[..., :H]
    bias = torch.tensor(_np(rng, (H,), 8.0))
    g = torch.tensor(_np(rng, (B, T, H)))
    assert bool((raw.float() + bias > 20).any())   # the linear branch too
    before = (ds.dt_softplus.launches, ds.dt_softplus_bwd.launches)
    out = ds.dt_softplus(raw, bias)
    draw, dbias = ds.dt_softplus_bwd(g, raw, bias)
    assert (ds.dt_softplus.launches, ds.dt_softplus_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == F32
    assert scaled_err(out, ds.dt_softplus_plain(raw, bias)) <= 1e-6
    want_raw, want_bias = ds.dt_softplus_bwd_plain(g, raw, bias)
    assert draw.dtype == dtype and dbias.dtype == F32
    assert scaled_err(draw, want_raw) <= (3e-2 if dtype == BF16 else 1e-6)
    assert scaled_err(dbias, want_bias) <= 1e-5
    assert bits_equal(out, ds.dt_softplus(raw, bias))
    assert all(bits_equal(a, b) for a, b in zip(
        (draw, dbias), ds.dt_softplus_bwd(g, raw, bias)))


def test_dt_softplus_refuses(kernels_on_card):
    with pytest.raises(ValueError, match="do not fit"):
        ds.dt_softplus(torch.zeros((1, 4, 3)), torch.zeros(4))
    with pytest.raises(ValueError, match="fp32"):
        ds.dt_softplus_bwd(torch.zeros((1, 4, 3), dtype=BF16),
                           torch.zeros((1, 4, 3)), torch.zeros(3))
