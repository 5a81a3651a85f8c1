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

from repro.models import ssm as j_ssm
from repro_torch.kernels import causal_conv as cc
from repro_torch.kernels import dt_softplus as ds
from repro_torch.kernels import gated_norm as gn
from repro_torch.kernels import ssd_scan as ssd


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
