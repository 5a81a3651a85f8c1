"""The port's kernels' plain versions against the JAX package's Pallas
kernels in interpret mode (on the card, ``test_torch_cuda.py`` holds the
CUDA kernels against these plain versions).

Tolerances: the LSTM cell 1e-5 in fp32 and 3e-2 in bf16 (the cases of
``tests/test_kernels.py::test_lstm_cell``); fused advance carries and
every chunk boundary 1e-5; fused reverse cotangents 1e-5 and parameter
gradients 1e-4 of each leaf's scale (fp32, different summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import segment_pallas as j_sp
from repro.models import lstm as j_lstm
from repro_torch.convert import init_lstm_numpy, params_from_numpy
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import segment_fused as sf
from repro_torch.models import lstm

V, DX, DH, B = 17, 8, 12, 3


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ kernel 1


@pytest.mark.parametrize("Bn,Dx,Dh,bb", [(8, 16, 32, 4), (16, 8, 8, 16),
                                         (4, 64, 128, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_cell_plain_matches_pallas(Bn, Dx, Dh, bb, dtype):
    rng = np.random.default_rng(Bn * 1000 + Dh)
    arrs = [_np(rng, (Bn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
            _np(rng, (Dx + Dh, 4 * Dh), 0.1), np.zeros((4 * Dh,), np.float32)]
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    hn, cn = j_ops.lstm_cell(*[jnp.asarray(a, jdt) for a in arrs],
                             block_b=bb, interpret=True)
    before = lc.lstm_cell.launches
    th, tc = lc.lstm_cell(*[torch.tensor(a).to(tdt) for a in arrs])
    assert lc.lstm_cell.launches == before   # plain version: no launch
    assert th.dtype == tdt and tc.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(th.float().numpy(),
                               np.asarray(hn, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(tc.float().numpy(),
                               np.asarray(cn, np.float32), rtol=tol, atol=tol)


def test_lstm_cell_rejects_bad_shapes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shapes"):
        lc.lstm_cell(x, torch.zeros(4, 6), torch.zeros(4, 6),
                     torch.zeros(13, 24), torch.zeros(24))


# ------------------------------------------------------- kernels 2 and 3


def _segment_operands(T, seed):
    rng = np.random.default_rng(seed)
    ref = init_lstm_numpy(seed, V, DX, DH)
    carry = (_np(rng, (B, DH), 0.5), _np(rng, (B, DH), 0.5),
             np.float32(1.5))
    tok = rng.integers(0, V, (T, B)).astype(np.int32)
    tgt = rng.integers(0, V, (T, B)).astype(np.int32)
    dcarry = (_np(rng, (B, DH), 0.1), _np(rng, (B, DH), 0.1),
              np.float32(0.7))
    return ref, carry, (tok, tgt), dcarry


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return tuple(torch.tensor(np.asarray(a)) for a in tree)


J_BODY = j_lstm.train_chain().body
T_BODY = lstm.train_chain().body
XS_TREEDEF = jax.tree_util.tree_structure((0, 0))


@pytest.mark.parametrize("T,chunk", [
    (23, 5),    # uneven chunk tail (3)
    (21, 5),    # length-1 tail: merged into the previous chunk
    (20, 5),    # even chunks
    (7, 7),     # one chunk
])
def test_fused_advance_plain_matches_pallas(T, chunk):
    ref, carry, xs, _ = _segment_operands(T, seed=T)
    j_out, j_bnd = j_sp.fused_advance_segment(
        J_BODY, XS_TREEDEF, (False, False), _to_jax(ref), _to_jax(carry),
        _to_jax(xs), None, chunk=chunk, interpret=True)
    out = sf.fused_advance_segment(
        T_BODY, params_from_numpy(ref, device="cpu"), _to_torch(carry),
        _to_torch(xs), None, chunk=chunk)
    assert out.ready is None
    nc = len(sf.forward_bounds(T, chunk)) - 1
    assert j_bnd[0].shape[0] == nc == out.boundaries[0].shape[0]
    for a, b in zip(out.carry, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(out.boundaries, j_bnd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("T,chunk", [
    (23, 5),    # short tail chunk (3): added once at the end
    (21, 5),    # length-1 tail chunk
    (20, 5),    # even chunks
    (6, 6),     # one chunk
])
def test_fused_reverse_plain_matches_pallas(T, chunk):
    ref, carry, xs, dcarry = _segment_operands(T, seed=100 + T)
    j_dc, j_dp, j_dxd = j_sp.fused_reverse_segment(
        J_BODY, XS_TREEDEF, (False, False), _to_jax(ref), _to_jax(carry),
        _to_jax(xs), None, _to_jax(dcarry), chunk=chunk, interpret=True)
    dc, dp, dxd = sf.fused_reverse_segment(
        T_BODY, (False, False), params_from_numpy(ref, device="cpu"),
        _to_torch(carry), _to_torch(xs), None, _to_torch(dcarry),
        chunk=chunk)
    assert dxd == [] and list(j_dxd) == []
    for a, b in zip(dc, j_dc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert set(dp) == set(j_dp)
    for k in j_dp:
        jb = np.asarray(j_dp[k])
        np.testing.assert_allclose(dp[k].numpy(), jb, rtol=1e-4,
                                   atol=1e-4 * max(1e-6, np.abs(jb).max()),
                                   err_msg=k)


def test_fused_plain_versions_take_any_body():
    """Off the card the plain versions run any chain body (here a
    registered-nowhere toy chain), with the JAX kernels' chunk layout."""
    def body(p, c, x, batch):
        return (torch.tanh(c[0] * p["a"] + x), c[1] + (c[0] ** 2).sum())

    params = {"a": torch.tensor(0.7)}
    carry = (torch.zeros(3), torch.tensor(0.0))
    xs = torch.linspace(-1.0, 1.0, 11)[:, None].repeat(1, 3)
    out = sf.fused_advance_segment(body, params, carry, xs, None, chunk=4)
    assert out.boundaries[0].shape == (3, 3)
    dc, dp, dxd = sf.fused_reverse_segment(
        body, (True,), params, carry, xs, None,
        (torch.zeros(3), torch.tensor(1.0)), chunk=4)
    leaves = {"a": params["a"].clone().requires_grad_(True)}
    xsg = xs.clone().requires_grad_(True)
    c = carry
    for k in range(11):
        c = body(leaves, c, xsg[k], None)
    ga, gx = torch.autograd.grad(c[1], [leaves["a"], xsg])
    torch.testing.assert_close(dp["a"], ga, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dxd[0], gx, rtol=1e-5, atol=1e-6)


def test_unregistered_body_is_refused_for_the_card():
    """An unregistered body is of the generic kind (its card path is the
    entry_store and fold kernels around its own steps), which the LSTM
    segment kernels refuse; an unknown kind cannot be registered."""
    body = lambda p, c, x, b: c   # noqa: E731
    assert sf.body_kind(body) == sf.GENERIC
    assert sf.body_kind(T_BODY) == "lstm"
    with pytest.raises(ValueError, match="supported|bodies"):
        sf.CapturedRun(body, {}, (torch.zeros((1, 1)),) * 2)
    with pytest.raises(ValueError, match="generic"):
        sf._fused_reverse_card(body, {}, None, None, None, chunk=1)
    with pytest.raises(ValueError):
        sf.register_body(body, "transformer")
    with pytest.raises(ValueError):
        sf.register_body(body, sf.GENERIC)


@pytest.mark.parametrize("T,chunk,nc", [(23, 5, 5), (21, 5, 4), (1, 5, 1)])
def test_forward_chunk_layout(T, chunk, nc):
    bounds = sf.forward_bounds(T, chunk)
    assert bounds[0] == 0 and bounds[-1] == T and len(bounds) - 1 == nc
    assert all(hi - lo >= 2 for lo, hi in zip(bounds[:-1], bounds[1:])) \
        or nc == 1


def test_token_range_is_checked_before_the_card(monkeypatch):
    """The CUDA kernels index the embedding and the logits with the token
    ids, so the front-end checks their range once on the host."""
    monkeypatch.setattr(sf, "_on_cpu", lambda tree: False)
    params = params_from_numpy(init_lstm_numpy(0, V, DX, DH), device="cpu")
    ok = (torch.tensor([[0, V - 1]], dtype=torch.int32),
          torch.tensor([[V - 1, 0]], dtype=torch.int32))
    sf.check_token_range(T_BODY, params, ok)
    for bad in ((ok[0] + 1, ok[1]), (ok[0], ok[1] - 1)):
        with pytest.raises(ValueError, match="token ids must lie"):
            sf.check_token_range(T_BODY, params, bad)
