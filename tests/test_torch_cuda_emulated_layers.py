"""The layer kernels' CUDA sources (``csrc/rmsnorm.cu``, ``glu.cu``,
``rope.cu``) run on the CPU under the emulation of ``tests/_cuda_emu.py``
through their wrappers' card paths, against their plain versions: rmsnorm
(with and without the fused residual add, fp32, bf16 and mixed types, rows
that leave the backward's blocks several rows each; the 16-byte forms at
widths with idle lanes, a remainder, gemma2-2b's 2,304 and the backward's
two warps a row past 2,560, the general forms at widths that are not
multiples of 8; the backward with three consumers' cotangents and the
skip's) within 1e-5 (fp32) or
3e-2 (bf16) of the plain version's max |value|; glu (GeGLU and SwiGLU,
lengths with a tail after the 16-byte loads, a misaligned view) likewise;
rope's forward bit for bit (the kernel rounds each product and sum as the
plain version's operations do), its backward bit for bit in fp32.  Each kernel gives the same bits on two calls,
and refuses what it does not take with ``ValueError``.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import glu as glu_mod
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import rope as rope_mod
from repro_torch.models.layers import rope_table

F32, BF16 = torch.float32, torch.bfloat16


def _t(rng, shape, dtype=F32, scale=1.0):
    return torch.tensor(_np(rng, shape, scale)).to(dtype)


def _tol(*dtypes):
    return 3e-2 if BF16 in dtypes else 1e-5


@pytest.mark.parametrize("rows,d,x_dt,out_dt,residual", [
    (300, 40, F32, F32, False),    # 16 rows a backward block, idle lanes
    (37, 300, BF16, BF16, True),   # a row wider than a block, residual
    (16, 64, F32, BF16, True),     # fp32 in, bf16 out (the final norm's)
    (9, 33, BF16, F32, False),
    # the 16-byte forms: 33 chunks of 8 (a lane holds two, the rest one)
    (40, 264, BF16, BF16, True),
    # gemma2-2b's width: nine chunks a lane, fp32 (the backward reads the
    # row again) and bf16 (kept in registers), three consumers' cotangents
    # and the skip's ("fanout": the backward of a pre-norm)
    (20, 2304, F32, F32, False),
    (36, 2304, BF16, BF16, "fanout"),
    # the general forms: a width that is not a multiple of 8, and the 16-byte
    # forms with a remainder, each with the fan-out backward
    (24, 100, BF16, BF16, "fanout"),
    (40, 264, BF16, BF16, "fanout"),
    # past 10 chunks a lane: two warps a row in the backward (2,696: 11
    # chunks a lane; phi3.5-moe's 4,096 in fp32 in, bf16 out)
    (24, 2696, BF16, BF16, "fanout"),
    (20, 4096, F32, BF16, True),
])
def test_rmsnorm_kernel_source(kernels_on_card, rows, d, x_dt, out_dt,
                               residual):
    fanout = residual == "fanout"
    rng = np.random.default_rng(rows + d)
    x = _t(rng, (rows, d), x_dt)
    scale = _t(rng, (d,), F32, 0.3)
    res = _t(rng, (rows, d), out_dt) if residual is True else None
    # g leans on x, so that the row's mean(g w xh) weighs in dx as much as
    # g itself (a wrong row sum shows)
    g = (_t(rng, (rows, d), F32) + x.float()).to(out_dt)
    more = [_t(rng, (rows, d), out_dt) for _ in range(2 * fanout)]
    dskip = _t(rng, (rows, d), x_dt) if fanout else None
    before = (rn.rmsnorm.launches, rn.rmsnorm_bwd.launches)
    out, rstd = rn.rmsnorm(x, scale, res, out_dtype=out_dt)

    def backward():
        return rn.rmsnorm_bwd(g, x, scale, rstd, g_more=more, dskip=dskip)

    dx, dscale = backward()
    assert (rn.rmsnorm.launches, rn.rmsnorm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want, want_rstd = rn.rmsnorm_fwd_plain(x, scale, res, 1e-6, out_dt)
    g_sum = g
    for t in more:   # each add rounded to the cotangents' type, in order
        g_sum = g_sum + t
    want_dx, want_ds = rn.rmsnorm_bwd_plain(g_sum, x, scale, 1e-6, out_dt)
    if fanout:
        want_dx = want_dx + dskip
    tol = _tol(x_dt, out_dt)
    assert out.dtype == out_dt and dx.dtype == x_dt and dscale.dtype == F32
    assert scaled_err(out, want) <= tol
    assert scaled_err(rstd, want_rstd.reshape(-1)) <= 1e-5
    assert scaled_err(dx, want_dx) <= tol
    assert scaled_err(dscale, want_ds) <= tol
    again = rn.rmsnorm(x, scale, res, out_dtype=out_dt)
    assert bits_equal(out, again[0]) and bits_equal(rstd, again[1])
    assert all(bits_equal(a, b) for a, b in zip((dx, dscale), backward()))


def test_rmsnorm_refuses(kernels_on_card):
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="residual"):
        rn.rmsnorm(x, torch.zeros(8), torch.zeros((4, 8), dtype=BF16))
    with pytest.raises(ValueError, match="scale"):
        rn.rmsnorm(x, torch.zeros(7))
    with pytest.raises(ValueError, match="float64"):
        rn.rmsnorm(x.double(), torch.zeros(8))


@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("n,dtype,offset", [
    (1001, BF16, 0),    # 125 16-byte vectors and a tail of 1
    (301, F32, 0),
    (200, BF16, 1),     # a view 2 bytes into its buffer: one value a load
])
def test_glu_kernel_source(kernels_on_card, act, n, dtype, offset):
    rng = np.random.default_rng(n + offset)
    gate, up, g = (_t(rng, (n + offset,), dtype, 2.0)[offset:]
                   for _ in range(3))
    before = (glu_mod.glu.launches, glu_mod.glu_bwd.launches)
    out = glu_mod.glu(gate, up, act)
    dgate, dup = glu_mod.glu_bwd(g, gate, up, act)
    assert (glu_mod.glu.launches, glu_mod.glu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    tol = _tol(dtype)
    assert scaled_err(out, glu_mod.glu_plain(gate, up, act)) <= tol
    for a, b in zip((dgate, dup), glu_mod.glu_bwd_plain(g, gate, up, act)):
        assert a.dtype == dtype and scaled_err(a, b) <= tol
    # one rounding of the fp32 value, as the kernel claims
    ref = glu_mod.glu_plain(gate.float(), up.float(), act)
    assert bool(((out.float() - ref).abs()
                 <= ref.abs() * (2.0 ** -8 if dtype == BF16 else 1e-6)
                 + 1e-30).all())
    assert bits_equal(out, glu_mod.glu(gate, up, act))
    assert all(bits_equal(a, b) for a, b in zip(
        (dgate, dup), glu_mod.glu_bwd(g, gate, up, act)))


def test_glu_refuses(kernels_on_card):
    with pytest.raises(ValueError, match="act"):
        glu_mod.glu(torch.zeros(4), torch.zeros(4), "relu")
    with pytest.raises(ValueError, match="differs"):
        glu_mod.glu(torch.zeros(4), torch.zeros(5), "gelu")


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shapes", [
    ((2, 5, 3, 16), (2, 5, 1, 16)),   # q and k in one launch (GQA)
    ((1, 7, 2, 256),),                # one tensor, gemma2-2b's head dim
])
def test_rope_kernel_source(kernels_on_card, dtype, shapes):
    rng = np.random.default_rng(len(shapes) + shapes[0][-1])
    S, D = shapes[0][1], shapes[0][-1]
    cos, sin = rope_table(S, D, device="cpu")
    xs = [_t(rng, s, dtype) for s in shapes]
    gs = [_t(rng, s, dtype) for s in shapes]
    before = (rope_mod.rope.launches, rope_mod.rope_bwd.launches)
    ys = rope_mod.rope(xs, cos, sin)
    dxs = rope_mod.rope_bwd(gs, cos, sin)
    assert (rope_mod.rope.launches, rope_mod.rope_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for x, y, g, dx in zip(xs, ys, gs, dxs):
        assert bits_equal(y, rope_mod.rope_plain(x, cos, sin))
        want = rope_mod.rope_bwd_plain(g, x, cos, sin)
        if dtype == F32:
            assert bits_equal(dx, want)
        else:   # one rounding against autograd's, which rounds each product
            assert dx.dtype == dtype and scaled_err(dx, want) <= 3e-2
    assert all(bits_equal(a, b)
               for a, b in zip(ys, rope_mod.rope(xs, cos, sin)))


def test_rope_refuses(kernels_on_card):
    cos, sin = rope_table(4, 8, device="cpu")
    with pytest.raises(ValueError, match="cos"):
        rope_mod.rope([torch.zeros((1, 5, 2, 8))], cos, sin)
    with pytest.raises(ValueError, match="does not fit"):
        rope_mod.rope([torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 6))],
                      cos, sin)
