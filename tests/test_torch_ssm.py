"""The port's Mamba-2 pieces against the JAX package, on the CPU.

* The SSD-scan kernel's plain version (``kernels.ssd_scan`` on CPU tensors,
  i.e. ``ssd_scan_ref`` over the flattened heads) and the chunked
  ``ssd_chunked`` against the Pallas kernel in interpret mode and JAX's
  ``ssd_chunked`` and ``ssd_sequential``, at the cases of
  ``tests/test_kernels.py``
  (``test_ssd_scan_shapes``, ``test_ssd_kernel_vs_flat_ref``): 2e-4.
* Gradients of ``ssd_chunked`` (and of :class:`SSDScan`, the card path's
  autograd Function, here over the kernels' plain versions) against
  ``jax.grad``: 2e-4 of each gradient's scale.
* ``mamba2_block`` against JAX, bf16 compute on both sides: 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.ssd_scan import ssd_scan as j_raw_ssd
from repro.models import ssm as j_ssm
from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import ssm


def _inputs(seed, B, T, H, G, P, N, with_h0=False):
    rng = np.random.default_rng(seed)

    def n(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    softplus = lambda a: np.log1p(np.exp(a)).astype(np.float32)  # noqa: E731
    out = {"x": n((B, T, H, P), 0.5), "dt": softplus(n((B, T, H))),
           "A": -np.exp(n((H,), 0.3)).astype(np.float32),
           "B": n((B, T, G, N), 0.5), "C": n((B, T, G, N), 0.5)}
    if with_h0:
        out["h0"] = n((B, H, P, N), 0.5)
    return out


def _close(a, b, tol=2e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("T,H,G,P,N,chunk", [
    (64, 4, 2, 16, 8, 16),
    (128, 2, 1, 32, 16, 32),
    (32, 8, 8, 8, 8, 32),   # chunk == T
])
def test_ssd_plain_versions_match_pallas(T, H, G, P, N, chunk):
    a = _inputs(T + H, 2, T, H, G, P, N)
    j_in = [jnp.asarray(a[k]) for k in ("x", "dt", "A", "B", "C")]
    wants = (j_ops.ssd_scan(*j_in, chunk=chunk, interpret=True),
             j_ssm.ssd_chunked(*j_in, chunk=chunk),
             j_ssm.ssd_sequential(*j_in))
    t_in = [torch.tensor(a[k]) for k in ("x", "dt", "A", "B", "C")]
    for y, h in (ssd.ssd_scan(*t_in, chunk=chunk),
                 ssm.ssd_chunked(*t_in, chunk=chunk),
                 ssm.ssd_sequential(*t_in)):
        for want_y, want_h in wants:
            _close(y, want_y)
            _close(h, want_h)


def test_ssd_flat_oracle_matches_the_pallas_kernel():
    rng = np.random.default_rng(16)
    BH, T, P, N = 3, 32, 8, 4
    x = (rng.standard_normal((BH, T, P)) * 0.5).astype(np.float32)
    la = -np.log1p(np.exp(rng.standard_normal((BH, T)))).astype(np.float32)
    b = (rng.standard_normal((BH, T, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((BH, T, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BH, T)))).astype(np.float32)
    jy, jh = j_raw_ssd(*map(jnp.asarray, (x, la, b, c, dt)), chunk=8,
                       interpret=True)
    ry, rh = j_ref.ssd_scan_ref(*map(jnp.asarray, (x, la, b, c, dt)))
    y, h = ssd_scan_ref(*map(torch.tensor, (x, la, b, c, dt)))
    for want_y, want_h in ((jy, jh), (ry, rh)):
        _close(y, want_y)
        _close(h, want_h)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_grads_match_jax(with_h0):
    keys = ("x", "dt", "A", "B", "C") + (("h0",) if with_h0 else ())
    a = _inputs(5, 2, 48, 4, 2, 8, 6, with_h0)
    rng = np.random.default_rng(6)
    wy = rng.standard_normal((2, 48, 4, 8)).astype(np.float32)
    wh = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)

    def j_loss(*args):
        kw = {"h0": args[5]} if with_h0 else {}
        y, h = j_ssm.ssd_chunked(*args[:5], chunk=16, **kw)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    j_grads = jax.grad(j_loss, argnums=tuple(range(len(keys))))(
        *[jnp.asarray(a[k]) for k in keys])
    for fn in ("plain", "function"):
        ins = [torch.tensor(a[k]).requires_grad_(True) for k in keys]
        h0 = ins[5] if with_h0 else None
        if fn == "plain":
            y, h = ssm.ssd_chunked_plain(*ins[:5], chunk=16, h0=h0)
        else:   # the card path's autograd Function (plain kernel here)
            y, h = ssm.SSDScan.apply(*ins[:5], h0, 16)
        loss = (torch.sum(y * torch.tensor(wy))
                + torch.sum(h * torch.tensor(wh)))
        grads = torch.autograd.grad(loss, ins)
        for k, g, jg in zip(keys, grads, j_grads):
            jg = np.asarray(jg)
            np.testing.assert_allclose(
                g.numpy(), jg, rtol=2e-4, atol=2e-4 * np.abs(jg).max(),
                err_msg=f"{fn}: d{k}")
            assert np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches_jax(with_state):
    d, s = 32, dict(d_state=8, headdim=16, expand=2, ngroups=1, conv_k=4)
    B, T, chunk = 2, 24, 8
    params = jax.tree_util.tree_map(
        np.asarray, j_ssm.init_mamba2(jax.random.PRNGKey(3), d, **s))
    x = np.random.default_rng(7).standard_normal((B, T, d)).astype(
        np.float32)
    d_inner = s["expand"] * d
    nheads = d_inner // s["headdim"]
    conv_dim = d_inner + 2 * s["ngroups"] * s["d_state"]
    rng = np.random.default_rng(8)
    state = (rng.standard_normal((B, s["conv_k"] - 1, conv_dim)).astype(
        np.float32), rng.standard_normal(
            (B, nheads, s["headdim"], s["d_state"])).astype(np.float32)) \
        if with_state else None
    j_out, (j_conv, j_h) = j_ssm.mamba2_block(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x, jnp.bfloat16),
        chunk=chunk, return_state=True,
        state=None if state is None else tuple(map(jnp.asarray, state)), **s)
    out, (conv, h) = ssm.mamba2_block(
        {k: (torch.tensor(v) if not isinstance(v, dict) else
             {kk: torch.tensor(vv) for kk, vv in v.items()})
         for k, v in params.items()},
        torch.tensor(x).to(torch.bfloat16), chunk=chunk, return_state=True,
        state=None if state is None else tuple(map(torch.tensor, state)),
        **s)
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(j_out, np.float32), 3e-2)
    _close(conv, j_conv, 3e-2)
    _close(h, j_h, 3e-2)


class _OnTheCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def test_failed_build_raises_instead_of_falling_back(monkeypatch):
    def no_build(name):
        raise RuntimeError(f"CUDA kernel build failed ({name})")

    monkeypatch.setattr(build, "load", no_build)
    a = _inputs(0, 1, 8, 2, 1, 4, 4)
    x, dt, A, b, c = (torch.tensor(a[k]).as_subclass(_OnTheCard)
                      for k in ("x", "dt", "A", "B", "C"))
    before = ssd.ssd_scan.launches
    with pytest.raises(RuntimeError, match="build failed"):
        ssd.ssd_scan(x, dt, A, b, c, chunk=4)
    with pytest.raises(RuntimeError, match="build failed"):
        ssm.ssd_chunked(x, dt, A, b, c, chunk=4)
    assert ssd.ssd_scan.launches == before
