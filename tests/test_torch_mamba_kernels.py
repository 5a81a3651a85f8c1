"""The plain versions of mamba2's layer kernels against the JAX package, on
the CPU, in fp32 (the kernels are held against these plain versions, under
the emulation here and on the card):

* ``ssd_scan_bwd_plain`` against ``jax.vjp`` of
  ``repro.models.ssm.ssd_chunked`` (the reverse the TPU segment kernels
  trace), with and without an entry state: each leaf within 1e-4 of its
  max |g|;
* ``gated_norm_plain`` (the D skip and ``_gated_norm``, ``ssm.py:202-204``),
  ``causal_conv_plain`` with a carried window (``ssm.py:179-188``) and
  ``dt_softplus_plain`` (``ssm.py:194-195``), each forward and vjp against
  the reference's lines written out here (the reference has no function
  of its own for them but ``_gated_norm``): 1e-5 of each output's max
  |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cuda_emu import bits_equal, emulated_libs, kernels_on_card  # noqa: F401

from repro.models import ssm as j_ssm
from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels import dt_softplus as ds
from repro_torch.kernels import gated_norm as gn
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, (what, i)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_bwd_plain_matches_jax_vjp(with_h0):
    B, T, H, G, P, N, chunk = 2, 48, 4, 2, 8, 6, 16
    rng = np.random.default_rng(11)
    ins = [_np(rng, (B, T, H, P)),
           np.log1p(np.exp(_np(rng, (B, T, H)))),
           -np.exp(_np(rng, (H,), 0.3)),
           _np(rng, (B, T, G, N)), _np(rng, (B, T, G, N))]
    if with_h0:
        ins.append(_np(rng, (B, H, P, N)))
    dy, dhf = _np(rng, (B, T, H, P)), _np(rng, (B, H, P, N))

    def f(*a):
        return j_ssm.ssd_chunked(*a[:5], chunk=chunk,
                                 **({"h0": a[5]} if with_h0 else {}))

    _, vjp = jax.vjp(f, *[jnp.asarray(a) for a in ins])
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
    t = [torch.tensor(a) for a in ins] + ([] if with_h0 else [None])
    got = ssd.ssd_scan_bwd_plain(*t, torch.tensor(dy), torch.tensor(dhf),
                                 chunk=chunk)
    assert (got[5] is None) == (not with_h0)
    _close([g for g in got if g is not None], want, 1e-4, "ssd_scan_bwd")


def test_gated_norm_plain_matches_jax():
    B, T, H, P = 2, 5, 3, 8
    rng = np.random.default_rng(12)
    ins = [_np(rng, (B, T, H, P)), _np(rng, (B, T, H, P)), _np(rng, (H,)),
           _np(rng, (B, T, H * P)), _np(rng, (H * P,), 0.3)]
    g = _np(rng, (B, T, H * P))

    def j_gate(y, x, D, z, scale):     # ssm.py:202-204, fp32 compute
        y = y + D.astype(y.dtype)[None, None, :, None] * x
        y = y.reshape(B, T, H * P)
        return j_ssm._gated_norm({"norm_scale": scale}, y, z).astype(
            jnp.float32)

    out, vjp = jax.vjp(j_gate, *[jnp.asarray(a) for a in ins])
    t = [torch.tensor(a) for a in ins]
    _close([gn.gated_norm_plain(*t, 1e-6, torch.float32)], [out], 1e-5,
           "gated_norm")
    _close(gn.gated_norm_bwd_plain(torch.tensor(g), *t, 1e-6, torch.float32),
           vjp(jnp.asarray(g)), 1e-5, "gated_norm_bwd")


def test_causal_conv_plain_matches_jax():
    B, T, C, K = 2, 9, 12, 4
    rng = np.random.default_rng(13)
    ins = [_np(rng, (B, T, C)), _np(rng, (K, C), 0.5), _np(rng, (C,), 0.5),
           _np(rng, (B, K - 1, C))]
    g = _np(rng, (B, T, C))

    def j_conv(xbc, w, b, win):        # ssm.py:179-188, fp32 compute
        pad = jnp.concatenate([win.astype(xbc.dtype), xbc], axis=1)
        conv = sum(pad[:, i:i + T, :] * w[i][None, None, :]
                   for i in range(K)) + b
        return jax.nn.silu(conv), pad[:, T:, :]

    (out, win), vjp = jax.vjp(j_conv, *[jnp.asarray(a) for a in ins])
    t = [torch.tensor(a) for a in ins]
    _close(cc.causal_conv_plain(*t), [out, win], 1e-5, "causal_conv")
    _close(cc.causal_conv_bwd_plain(torch.tensor(g), *t),
           vjp((jnp.asarray(g), jnp.zeros_like(win))), 1e-5,
           "causal_conv_bwd")


def test_dt_softplus_plain_matches_jax():
    rng = np.random.default_rng(14)
    raw, bias = _np(rng, (2, 7, 4), 12.0), _np(rng, (4,), 8.0)
    g = _np(rng, (2, 7, 4))
    assert (raw + bias > 20).any()    # past PyTorch's linear threshold

    def j_dt(r, b):                    # ssm.py:194-195
        return jax.nn.softplus(r.astype(jnp.float32) + b.astype(jnp.float32))

    out, vjp = jax.vjp(j_dt, jnp.asarray(raw), jnp.asarray(bias))
    t = [torch.tensor(raw), torch.tensor(bias)]
    _close([ds.dt_softplus_plain(*t)], [out], 1e-6, "dt_softplus")
    _close(ds.dt_softplus_bwd_plain(torch.tensor(g), *t), vjp(jnp.asarray(g)),
           1e-6, "dt_softplus_bwd")


# mamba2's mixer at SMOKE width (d_model 64): d_inner 128 (8 heads of 16),
# one group of state 8, conv width 4; d_proj = 2 128 + 2 8 + 8 = 280
MIX = dict(d_inner=128, headdim=16, ngroups=1, d_state=8, conv_k=4,
           chunk=8)
MIX_B, MIX_T = 2, 24


def _mixer_case(seed):
    rng = np.random.default_rng(seed)
    d_inner, gn = MIX["d_inner"], MIX["ngroups"] * MIX["d_state"]
    nheads = d_inner // MIX["headdim"]
    d_proj = 2 * d_inner + 2 * gn + nheads
    bf = torch.bfloat16

    def t(shape, scale=1.0, dtype=torch.float32):
        return torch.tensor((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dtype)

    zx = t((MIX_B, MIX_T, d_proj), 1.0, bf)
    p = {"conv_w": t((MIX["conv_k"], d_inner + 2 * gn), 0.3),
         "conv_b": t((d_inner + 2 * gn,), 0.1),
         "dt_bias": t((nheads,), 0.5), "A_log": t((nheads,), 0.5),
         "D": t((nheads,), 1.0), "norm_scale": t((d_inner,), 0.1)}
    return zx, p, t((MIX_B, MIX_T, d_inner), 1.0, bf)


def _mixer_grads(zx0, p0, cot, composed):
    """The mixer's output and the gradients of ``zxbcdt`` and every
    parameter: through ``ssm._Mixer`` or (``composed``) through the
    kernels' separate autograd functions over the split's slices and
    concatenation, as the block ran before the mixer owned the split."""
    zx = zx0.clone().requires_grad_(True)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    d_inner, hd = MIX["d_inner"], MIX["headdim"]
    G, N = MIX["ngroups"], MIX["d_state"]
    bf = torch.bfloat16
    A = -torch.exp(p["A_log"].float())
    w, b = p["conv_w"].to(bf), p["conv_b"].to(bf)
    if composed:
        z, xi, Bc, Cc, dt_raw = ssm._split_proj(zx, d_inner, G, N,
                                                d_inner // hd)
        conv, _ = cc.conv_silu(torch.cat([xi, Bc, Cc], dim=-1), w, b)
        xh = conv[..., :d_inner].reshape(MIX_B, MIX_T, -1, hd)
        Bg = conv[..., d_inner:d_inner + G * N].reshape(MIX_B, MIX_T, G, N)
        Cg = conv[..., d_inner + G * N:].reshape(MIX_B, MIX_T, G, N)
        dts = ds.softplus_dt(dt_raw, p["dt_bias"])
        y, _ = ssm.ssd_chunked(xh, dts, A, Bg, Cg, chunk=MIX["chunk"])
        out = gn.gated_norm_out(y, xh, p["D"], z, p["norm_scale"],
                                out_dtype=bf)
    else:
        out, _ = ssm._Mixer.apply(zx, w, b, p["dt_bias"], A, p["D"],
                                  p["norm_scale"], None, None,
                                  (d_inner, G, N, hd, MIX["chunk"], bf))
    leaves = [zx] + [p[k] for k in sorted(p)]
    return (out,) + torch.autograd.grad(out, leaves, cot)


def test_mixer_owns_the_split_bit_for_bit(kernels_on_card):
    """On the emulated card, ``ssm._Mixer`` (the conv, step sizes and gated
    norm reading their columns of ``zxbcdt`` in place, the conv writing x,
    B and C apart, each backward kernel writing its columns of one
    uninitialised cotangent) against the same kernels composed over the
    split's slices and ``torch.cat``, whose gradient autograd assembles
    from zero-filled slices: the output and every parameter's gradient bit
    for bit; ``zxbcdt``'s equal in value (the zero fill turned a -0.0 of a
    slice into +0.0, which the mixer keeps as -0.0)."""
    zx, p, cot = _mixer_case(21)
    got = _mixer_grads(zx, p, cot, composed=False)
    want = _mixer_grads(zx, p, cot, composed=True)
    assert len(got) == len(want)
    assert torch.equal(got[1], want[1])
    for i, (a, b) in enumerate(zip(got, want)):
        assert i == 1 or bits_equal(a, b), i


def test_mixer_writes_every_column(kernels_on_card, monkeypatch):
    """The mixer's backward fills a NaN-filled ``(B, T, d_proj)`` buffer in
    place of its uninitialised one: every column comes back written (no
    NaN left) and the gradient is the one it gives otherwise."""
    zx, p, cot = _mixer_case(22)
    want = _mixer_grads(zx, p, cot, composed=False)
    buffers = []

    def nan_buffer(t):
        buffers.append(torch.full_like(t, float("nan")))
        return buffers[-1]

    monkeypatch.setattr(ssm, "_proj_grad_buffer", nan_buffer)
    got = _mixer_grads(zx, p, cot, composed=False)
    assert len(buffers) == 1 and buffers[0].shape == zx.shape
    assert not bool(torch.isnan(buffers[0]).any())
    assert got[1].data_ptr() == buffers[0].data_ptr()
    assert all(bits_equal(a, b) for a, b in zip(got, want))


def test_column_pieces_and_strided_outputs_bit_for_bit(kernels_on_card):
    """The kernels' split forms against their one-tensor forms (bf16,
    emulated): the conv's x, B, C pieces are the columns of its one
    output; its backward from pieces with an addend on the first (rounded
    as autograd adds it) and into a strided view is its backward from the
    assembled cotangent; the step sizes' and the gated norm's backwards
    into strided views are their own outputs; a view no kernel can read
    raises."""
    zx, p, _ = _mixer_case(23)
    rng = np.random.default_rng(24)
    d_inner, gn_ = MIX["d_inner"], MIX["ngroups"] * MIX["d_state"]
    bf = torch.bfloat16
    c1 = 2 * d_inner + 2 * gn_
    xbc, dt_raw, z = zx[..., d_inner:c1], zx[..., c1:], zx[..., :d_inner]
    w, b = p["conv_w"].to(bf), p["conv_b"].to(bf)
    whole = cc.causal_conv(xbc, w, b)
    pieces = cc.causal_conv(xbc, w, b, splits=(d_inner, gn_, gn_))
    assert all(bits_equal(a, b_) for a, b_ in zip(
        pieces, torch.split(whole, [d_inner, gn_, gn_], dim=-1)))

    def t(shape):
        return torch.tensor(rng.standard_normal(shape)
                            .astype(np.float32)).to(bf)

    gs = [t(q.shape) for q in pieces]
    add = t(gs[0].shape)
    buf = torch.full_like(zx, float("nan"))
    got = cc.causal_conv_bwd(tuple(gs), xbc, w, b, g_add=add,
                             dx_out=buf[..., d_inner:c1])
    want = cc.causal_conv_bwd(torch.cat([gs[0] + add] + gs[1:], dim=-1),
                              xbc, w, b)
    assert got[0].data_ptr() == buf[..., d_inner:c1].data_ptr()
    assert all(bits_equal(a, b_) for a, b_ in zip(got[:3], want[:3]))
    assert not bool(torch.isnan(buf[..., d_inner:c1]).any())

    g = torch.tensor(rng.standard_normal(dt_raw.shape).astype(np.float32))
    got = ds.dt_softplus_bwd(g, dt_raw, p["dt_bias"], draw_out=buf[..., c1:])
    want = ds.dt_softplus_bwd(g, dt_raw, p["dt_bias"])
    assert all(bits_equal(a, b_) for a, b_ in zip(got, want))

    hd = MIX["headdim"]
    y = t((MIX_B, MIX_T, d_inner // hd, hd))
    xh = pieces[0].view(MIX_B, MIX_T, -1, hd)
    _, rstd = gn.gated_norm(y, xh, p["D"], z, p["norm_scale"], out_dtype=bf)
    g = t((MIX_B, MIX_T, d_inner))
    got = gn.gated_norm_bwd(g, y, xh, p["D"], z, p["norm_scale"], rstd,
                            dz_out=buf[..., :d_inner])
    want = gn.gated_norm_bwd(g, y, xh, p["D"], z, p["norm_scale"], rstd)
    assert all(bits_equal(a, b_) for a, b_ in zip(got, want))
    assert not bool(torch.isnan(buf).any())
    with pytest.raises(ValueError):
        cc.causal_conv(xbc.transpose(0, 1), w, b)
