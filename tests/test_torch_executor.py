"""The port's checkpoint executor against the JAX package's, on the CPU.

A toy chain ``x_{k+1} = tanh(x_k W + 0.01 k)`` with the adjoint ``(dx,
dW)`` (inputs drawn from a numpy seed) runs through both executors' three
strategies — store-all, classic Revolve with ``s`` slots, and the
interpreted multistage engine over ``(n, I, s)`` — under hypothesis sweeps
(``n <= 40``).  ``advances``, ``backwards``, ``host_dispatches``,
``peak_l1_states``, ``peak_l1_bytes`` and ``recompute_factor`` (and, for
the multistage engine, the Level-2 counters) must be *equal*, and the
adjoints agree within 1e-5.  The LSTM's per-step executor operators
(``make_operators``) are held against the JAX package's within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core.executor import CheckpointExecutor as JExecutor
from repro.models import lstm as j_lstm
from repro_torch.convert import init_lstm_numpy, params_from_numpy
from repro_torch.core import revolve as rv
from repro_torch.core.executor import CheckpointExecutor
from repro_torch.models import lstm

B, D = 3, 6
COUNTERS = ("advances", "backwards", "host_dispatches", "peak_l1_states",
            "peak_l1_bytes", "recompute_factor")
L2_COUNTERS = ("l2_stores", "l2_prefetches", "l2_peak_bytes")


def _chain_inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((D, D)) * 0.5).astype(np.float32)
    x0 = rng.standard_normal((B, D)).astype(np.float32)
    dxn = rng.standard_normal((B, D)).astype(np.float32)
    return w, x0, dxn


class _JaxChain:
    def __init__(self, w):
        w = jnp.asarray(w)

        def step(x, k):
            return jnp.tanh(x @ w + 0.01 * k)

        @jax.jit
        def bwd(x, adj, k):
            dx, gw = adj
            _, vjp = jax.vjp(lambda x_, w_: jnp.tanh(x_ @ w_ + 0.01 * k),
                             x, w)
            dx, dw = vjp(dx)
            return dx, gw + dw

        self.fwd = jax.jit(step)
        self.bwd = bwd
        self.w = w


class _TorchChain:
    def __init__(self, w):
        self.w = torch.as_tensor(w)

    def fwd(self, x, k):
        return torch.tanh(x @ self.w + 0.01 * k)

    def bwd(self, x, adj, k):
        dx, gw = adj
        with torch.enable_grad():
            xi = x.detach().requires_grad_(True)
            wi = self.w.detach().requires_grad_(True)
            dx, dw = torch.autograd.grad(torch.tanh(xi @ wi + 0.01 * k),
                                         (xi, wi), dx)
        return dx, gw + dw


@pytest.fixture(scope="module")
def chains():
    w, x0, dxn = _chain_inputs()
    return _JaxChain(w), _TorchChain(w), x0, dxn


def _run(chains, method, n, **kw):
    jc, tc, x0, dxn = chains
    j_adj, j_stats = getattr(JExecutor(jc.fwd, jc.bwd), method)(
        jnp.asarray(x0), n, (jnp.asarray(dxn), jnp.zeros((D, D))), **kw)
    t_adj, t_stats = getattr(CheckpointExecutor(tc.fwd, tc.bwd), method)(
        torch.as_tensor(x0), n,
        (torch.as_tensor(dxn), torch.zeros((D, D))), **kw)
    for a, b in zip(t_adj, j_adj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    return t_stats, j_stats


def _assert_counters(t_stats, j_stats, names=COUNTERS):
    for name in names:
        assert getattr(t_stats, name) == getattr(j_stats, name), name


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 40), s=st.integers(1, 10))
def test_revolve_matches_the_reference(chains, n, s):
    t_stats, j_stats = _run(chains, "run_revolve", n, s=s)
    _assert_counters(t_stats, j_stats)
    assert t_stats.advances == rv.count_advances(rv.revolve_schedule(n, s))
    assert t_stats.peak_l1_states <= s


@settings(max_examples=8, deadline=None)
@given(n=st.integers(1, 40))
def test_conventional_matches_the_reference(chains, n):
    t_stats, j_stats = _run(chains, "run_conventional", n)
    _assert_counters(t_stats, j_stats)
    assert t_stats.advances == t_stats.backwards == t_stats.peak_l1_states \
        == n


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 40), interval=st.integers(1, 16),
       s=st.integers(1, 6))
def test_interpreted_multistage_matches_the_reference(chains, n, interval,
                                                      s):
    t_stats, j_stats = _run(chains, "run_multistage", n, interval=interval,
                            s_l1=s)
    _assert_counters(t_stats, j_stats, COUNTERS + L2_COUNTERS)


@pytest.mark.parametrize("method,kw", [
    ("run_revolve", {"s": 4}),
    ("run_conventional", {}),
    ("run_multistage", {"interval": 5, "s_l1": 2}),
])
def test_final_hook_seeds_the_adjoint_from_x_n(chains, method, kw):
    """``final_hook(x_n)`` seeds the adjoint after the forward sweep (the
    loss ``sum(x_n^2)`` here), with the reference's counters."""
    jc, tc, x0, _ = chains
    n = 23
    j_adj, j_stats = getattr(JExecutor(jc.fwd, jc.bwd), method)(
        jnp.asarray(x0), n, None,
        final_hook=lambda xn: (2.0 * xn, jnp.zeros((D, D))), **kw)
    t_adj, t_stats = getattr(CheckpointExecutor(tc.fwd, tc.bwd), method)(
        torch.as_tensor(x0), n, None,
        final_hook=lambda xn: (2.0 * xn, torch.zeros((D, D))), **kw)
    for a, b in zip(t_adj, j_adj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    _assert_counters(t_stats, j_stats)


# ---------------------------------------------------------------------------
# the LSTM's per-step executor operators
# ---------------------------------------------------------------------------

V, DX, DH = 17, 8, 12


def test_make_operators_match_the_reference():
    """Per-step forward and backward of ``models.lstm.make_operators``
    against the JAX package's at every step of a short chain, within
    1e-5, and both driven through Revolve to the same gradients."""
    ref = init_lstm_numpy(2, V, DX, DH)
    tok = np.random.default_rng(2).integers(0, V, (B, 9)).astype(np.int32)
    j_fwd, j_bwd, j_seed, j_T = j_lstm.make_operators(
        {k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(tok))
    fwd, bwd, seed, T = lstm.make_operators(params_from_numpy(ref,
                                                              device="cpu"),
                                            torch.as_tensor(tok))
    assert T == j_T == 8

    def close(a, b):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            y = np.asarray(y)
            np.testing.assert_allclose(np.asarray(x), y, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(y).max(), 1))

    adj, j_adj = seed(), j_seed()
    close(adj, j_adj)
    rng = np.random.default_rng(3)
    for k in range(T):
        h = (rng.standard_normal((B, DH)) * 0.5).astype(np.float32)
        c = (rng.standard_normal((B, DH)) * 0.5).astype(np.float32)
        state = (torch.as_tensor(h), torch.as_tensor(c), torch.tensor(0.5))
        j_state = (jnp.asarray(h), jnp.asarray(c), jnp.float32(0.5))
        close(fwd(state, k), j_fwd(j_state, k))
        adj = bwd(state, adj, k)
        j_adj = j_bwd(j_state, j_adj, k)
        close(adj, j_adj)
    # the whole chain under Revolve with 3 slots
    state0 = (torch.zeros((B, DH)), torch.zeros((B, DH)), torch.tensor(0.0))
    (_, grads), stats = CheckpointExecutor(fwd, bwd).run_revolve(
        state0, T, seed(), s=3)
    (_, j_grads), j_stats = JExecutor(j_fwd, j_bwd).run_revolve(
        (jnp.zeros((B, DH)), jnp.zeros((B, DH)), jnp.float32(0.0)), j_T,
        j_seed(), s=3)
    close(grads, j_grads)
    _assert_counters(stats, j_stats)
