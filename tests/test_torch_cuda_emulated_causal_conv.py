"""The causal conv's CUDA source (``csrc/causal_conv.cu``: Mamba-2's
causal depthwise conv over (x, B, C) with its bias and SiLU) run on the
CPU under the emulation of ``tests/_cuda_emu.py`` through its wrapper's
card path, against its plain version: the output and every cotangent
(dxbc, dw, dbias, the carried window's) within 1e-5 (fp32) or 3e-2 (bf16)
of the plain version's max |value| -- the kernel sums the K products and
the bias in fp32 and rounds once, where the plain version rounds each --
with and without a carried window, xbc a column slice of wider rows, a
sequence shorter than the window (the new window built, not a view);
the same bits on two calls.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import causal_conv as cc

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("B,T,C,K,dtype,window,wide", [
    (2, 30, 40, 4, F32, True, 3),     # carried window, a strided view
    (1, 37, 300, 4, BF16, False, 0),  # channels over one block
    (2, 2, 9, 4, BF16, True, 0),      # T < K - 1
    (1, 65, 8, 2, F32, False, 0),     # 65 rows: two weight-sum blocks
])
def test_causal_conv_kernel_source(kernels_on_card, B, T, C, K, dtype,
                                   window, wide):
    rng = np.random.default_rng(B + T + C)
    t = lambda shape, s=1.0: torch.tensor(_np(rng, shape, s)).to(dtype)  # noqa: E731
    xbc = t((B, T, C + wide))[..., wide:]
    w, bias = t((K, C), 0.5), t((C,), 0.5)
    win = t((B, K - 1, C)) if window else None
    g = t((B, T, C))
    before = (cc.causal_conv.launches, cc.causal_conv_bwd.launches)
    out = cc.causal_conv(xbc, w, bias, win)
    grads = cc.causal_conv_bwd(g, xbc, w, bias, win)
    assert (cc.causal_conv.launches, cc.causal_conv_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    tol = 3e-2 if dtype == BF16 else 1e-5
    want, new_win = cc.causal_conv_plain(xbc, w, bias, win)
    assert out.dtype == dtype and scaled_err(out, want) <= tol
    for name, a, b in zip(("dxbc", "dw", "dbias", "dwindow"), grads,
                          cc.causal_conv_bwd_plain(g, xbc, w, bias, win)):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert scaled_err(a, b) <= tol, (name, scaled_err(a, b))
    assert bits_equal(out, cc.causal_conv(xbc, w, bias, win))
    assert all(a is None or bits_equal(a, b) for a, b in zip(
        grads, cc.causal_conv_bwd(g, xbc, w, bias, win)))
    # the model's entry: the kernels under autograd, the same new window
    got, got_win = cc.conv_silu(xbc, w.float(), bias.float(), win, dtype)
    assert bits_equal(got, out) and bits_equal(got_win, new_win)


def test_causal_conv_refuses(kernels_on_card):
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="width K"):
        cc.causal_conv(x, torch.zeros((9, 8)), torch.zeros(8))
    with pytest.raises(ValueError, match="window"):
        cc.causal_conv(x, torch.zeros((4, 8)), torch.zeros(8),
                       torch.zeros((1, 2, 8)))
