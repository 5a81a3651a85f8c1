"""The gated norm's CUDA source (``csrc/gated_norm.cu``: Mamba-2's D skip,
SiLU gate and RMSNorm) run on the CPU under the emulation of
``tests/_cuda_emu.py`` through its wrapper's card path, against its plain
version: the output and every cotangent (dy, the skip's dx, dD, dz,
dscale) within 1e-5 (fp32) or 3e-2 (bf16) of the plain version's max
|value|, with x and z read in place as column slices of wider rows, rows
that leave the backward's blocks several rows each, fp32 output from bf16
inputs; the forward keeps the plain version's two bf16 roundings of the
skip (bit for bit in bf16 where the norm is fp32-exact: a unit scale and
fp32 output); the same bits on two calls.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import gated_norm as gn

F32, BF16 = torch.float32, torch.bfloat16


def _case(rng, B, T, H, P, dtype, wide):
    """y (B, T, H, P); x and z column slices of (B, T, wide) rows."""
    d = H * P
    t = lambda shape, s=1.0: torch.tensor(_np(rng, shape, s)).to(dtype)  # noqa: E731
    y = t((B, T, H, P))
    xbc = t((B, T, d + wide))
    zx = t((B, T, 2 * d + wide))
    x = xbc[..., :d].reshape(B, T, H, P)
    z = zx[..., :d]
    D = torch.tensor(_np(rng, (H,)))
    scale = torch.tensor(_np(rng, (d,), 0.3))
    return y, x, D, z, scale


@pytest.mark.parametrize("B,T,H,P,dtype,out_dtype,wide", [
    (1, 40, 2, 8, F32, F32, 5),      # 40 rows: 16 a backward block
    (2, 9, 4, 16, BF16, BF16, 3),    # the model's bf16 path
    (1, 7, 3, 8, BF16, F32, 0),      # bf16 in, fp32 out
])
def test_gated_norm_kernel_source(kernels_on_card, B, T, H, P, dtype,
                                  out_dtype, wide):
    rng = np.random.default_rng(B * T + H)
    y, x, D, z, scale = _case(rng, B, T, H, P, dtype, wide)
    g = torch.tensor(_np(rng, (B, T, H * P))).to(out_dtype)
    before = (gn.gated_norm.launches, gn.gated_norm_bwd.launches)
    out, rstd = gn.gated_norm(y, x, D, z, scale, out_dtype=out_dtype)
    grads = gn.gated_norm_bwd(g, y, x, D, z, scale, rstd)
    assert (gn.gated_norm.launches, gn.gated_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    tol = 3e-2 if BF16 in (dtype, out_dtype) else 1e-5
    want = gn.gated_norm_plain(y, x, D, z, scale, 1e-6, out_dtype)
    assert out.dtype == out_dtype and scaled_err(out, want) <= tol
    wants = gn.gated_norm_bwd_plain(g, y, x, D, z, scale, 1e-6, out_dtype)
    for name, a, b in zip(("dy", "dx", "dD", "dz", "dscale"), grads, wants):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert scaled_err(a, b) <= tol, (name, scaled_err(a, b))
    again = gn.gated_norm(y, x, D, z, scale, out_dtype=out_dtype)
    assert bits_equal(out, again[0]) and bits_equal(rstd, again[1])
    assert all(bits_equal(a, b) for a, b in zip(
        grads, gn.gated_norm_bwd(g, y, x, D, z, scale, rstd)))


def test_gated_norm_keeps_the_skips_roundings(kernels_on_card):
    """bf16 y and x, fp32 output: the kernel's skip rounds D x and then
    y + D x to bf16 as the plain version does (within 1e-5 of it), where
    a skip taken in fp32 gives another output (more than 1e-5 away)."""
    rng = np.random.default_rng(3)
    y, x, D, z, scale = _case(rng, 1, 6, 2, 8, BF16, 0)
    out, _ = gn.gated_norm(y, x, D, z, scale, out_dtype=F32)
    want = gn.gated_norm_plain(y, x, D, z, scale, 1e-6, F32)
    fp32_skip = gn.gated_norm_plain(y.float(), x.float(), D, z, scale, 1e-6,
                                    F32)
    assert scaled_err(out, want) <= 1e-5 < scaled_err(fp32_skip, want)


def test_gated_norm_refuses(kernels_on_card):
    y = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="do not fit"):
        gn.gated_norm(y, y, torch.zeros(3), torch.zeros((1, 4, 16)),
                      torch.zeros(16))
    with pytest.raises(ValueError, match="share a dtype"):
        gn.gated_norm(y, y.to(BF16), torch.zeros(2), torch.zeros((1, 4, 16)),
                      torch.zeros(16))
