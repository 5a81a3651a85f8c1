"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) on the
CPU: the JAX package's ``tests/test_moe.py`` case for case against a
per-token oracle, then each function against its JAX counterpart.

Inputs are the JAX package's own (``init_moe`` under a fixed key, normal
activations), carried over with ``params_from_numpy``.  Tolerances, all in
fp32 compute: the oracle cases at the reference's rtol 1e-4, atol 1e-5;
against JAX, routing indices, capacity and every routed/kept count equal,
routing weights, outputs and the aux loss within 1e-5 (rtol and atol),
gradients within 1e-5 of each leaf's max |g|.

The sorted dispatch differs from the JAX package's under overflow on
purpose: the JAX package's loses the rank-0 token of each overflowing
expert (``test_reference_sorted_loses_rank0_tokens_under_overflow`` states
that), the port keeps exactly ``min(count, C)`` tokens an expert, with the
kept tokens' outputs those of the oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st  # optional dep, see shim
from torch.utils import _pytree as pytree

from repro.models import moe as j_moe
from repro.models.layers import DTypes as JDTypes
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.models.layers import DTypes

DT, J_DT = DTypes(compute=torch.float32), JDTypes(compute=jnp.float32)
KEY = jax.random.PRNGKey(0)
IMPLS = {"einsum": moe.moe_einsum, "sorted": moe.moe_sorted}
J_IMPLS = {"einsum": j_moe.moe_einsum, "sorted": j_moe.moe_sorted}


def _inputs(d, d_ff, E, shape, fold, shared=False):
    """(numpy params, numpy x) from the JAX package's init and key."""
    p = j_moe.init_moe(KEY, d, d_ff, E, shared_expert=shared)
    x = jax.random.normal(jax.random.fold_in(KEY, fold), shape)
    return jax.tree_util.tree_map(np.asarray, p), np.asarray(x)


def _port(p_np, x_np):
    return params_from_numpy(p_np, device="cpu"), torch.tensor(x_np)


def _oracle(p, x, E, k):
    """Per token, the weighted sum of its top-k experts' FFNs."""
    w, idx, _ = moe._route(p, x, E, k)
    G, S, _ = x.shape
    y = torch.zeros_like(x)
    for g in range(G):
        for s in range(S):
            for j in range(k):
                e = int(idx[g, s, j])
                gg, u = x[g, s] @ p["w_gate"][e], x[g, s] @ p["w_up"][e]
                y[g, s] += w[g, s, j] * ((torch.nn.functional.silu(gg) * u)
                                         @ p["w_down"][e])
    if "shared" in p:
        y = y + moe.mlp(p["shared"], x, dt=DT)
    return y


# --- the JAX package's tests/test_moe.py, case for case -------------------


@pytest.mark.parametrize("impl", ["einsum", "sorted"])
@pytest.mark.parametrize("E,k,shared", [(8, 2, False), (8, 1, True),
                                        (4, 2, True)])
def test_matches_oracle_no_drops(impl, E, k, shared):
    p, x = _port(*_inputs(32, 64, E, (3, 16, 32), 5, shared))
    with torch.no_grad():
        y, aux = IMPLS[impl](p, x, n_experts=E, top_k=k, capacity_factor=8.0,
                             dt=DT)
        np.testing.assert_allclose(y.numpy(), _oracle(p, x, E, k).numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert float(aux) > 0


def test_einsum_equals_sorted():
    E, k = 8, 2
    p, x = _port(*_inputs(32, 64, E, (2, 24, 32), 6))
    y1, a1 = moe.moe_einsum(p, x, n_experts=E, top_k=k, capacity_factor=8.0,
                            dt=DT)
    y2, a2 = moe.moe_sorted(p, x, n_experts=E, top_k=k, capacity_factor=8.0,
                            dt=DT)
    np.testing.assert_allclose(y1.detach().numpy(), y2.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-6)


def test_capacity_drops_tokens():
    """With a tiny capacity factor, dropped tokens' outputs become exactly
    zero (no shared expert here)."""
    E, k = 4, 1
    p, x = _port(*_inputs(16, 32, E, (1, 64, 16), 7))
    y_full, _ = moe.moe_einsum(p, x, n_experts=E, top_k=k,
                               capacity_factor=8.0, dt=DT)
    y_tight, _ = moe.moe_einsum(p, x, n_experts=E, top_k=k,
                                capacity_factor=0.25, dt=DT)
    changed = (y_full - y_tight).abs().gt(1e-6).any(-1)
    assert bool(changed.any())
    assert bool(y_tight.abs().lt(1e-7).all(-1).any())


@settings(deadline=None, max_examples=10)
@given(b=st.integers(1, 3), s=st.sampled_from([8, 16]),
       e=st.sampled_from([4, 8]), k=st.integers(1, 2))
def test_grads_finite_property(b, s, e, k):
    p_np, x_np = _inputs(16, 32, e, (b, s, 16), 8)
    for impl in IMPLS.values():
        p, x = _port(p_np, x_np)
        leaves, spec = pytree.tree_flatten(p)
        leaves = [t.requires_grad_(True) for t in leaves]
        y, _ = impl(pytree.tree_unflatten(leaves, spec), x, n_experts=e,
                    top_k=k, dt=DT)
        grads = torch.autograd.grad((y ** 2).sum(), leaves)
        assert all(bool(g.isfinite().all()) for g in grads)


def test_capacity_stats_are_load_accurate():
    """with_stats=True: routed counts sum to G*S*k, kept == routed -
    dropped, and the two dispatch implementations agree on every count."""
    E, k, G, S = 4, 1, 1, 64
    p, x = _port(*_inputs(16, 32, E, (G, S, 16), 7))
    y1, _, s1 = moe.moe_einsum(p, x, n_experts=E, top_k=k,
                               capacity_factor=0.25, dt=DT, with_stats=True)
    _, _, s2 = moe.moe_sorted(p, x, n_experts=E, top_k=k,
                              capacity_factor=0.25, dt=DT, with_stats=True)
    routed1, kept1 = s1["routed_counts"].numpy(), s1["expert_counts"].numpy()
    assert int(routed1.sum()) == G * S * k
    assert int(s1["dropped_tokens"]) == int(routed1.sum() - kept1.sum()) > 0
    assert (kept1 <= int(s1["capacity"])).all()
    np.testing.assert_array_equal(routed1, s2["routed_counts"].numpy())
    np.testing.assert_array_equal(kept1, s2["expert_counts"].numpy())
    # the stats opt-in does not change the computed output
    y_plain, _ = moe.moe_einsum(p, x, n_experts=E, top_k=k,
                                capacity_factor=0.25, dt=DT)
    assert torch.equal(y1, y_plain)


def test_routing_stats_host_helper_matches_dispatch():
    """routing_stats replicates the einsum keep accounting, as numpy."""
    E, k = 4, 2
    p, x = _port(*_inputs(16, 32, E, (2, 32, 16), 9))
    rs = moe.routing_stats(p, x, n_experts=E, top_k=k, capacity_factor=0.5)
    _, _, s = moe.moe_einsum(p, x, n_experts=E, top_k=k, capacity_factor=0.5,
                             dt=DT, with_stats=True)
    np.testing.assert_array_equal(rs["expert_counts"],
                                  s["expert_counts"].numpy())
    np.testing.assert_array_equal(rs["routed_counts"],
                                  s["routed_counts"].numpy())
    assert rs["dropped_tokens"] == int(s["dropped_tokens"]) > 0
    assert rs["capacity"] == int(s["capacity"])
    assert isinstance(rs["expert_counts"], np.ndarray)


# --- against the JAX package ----------------------------------------------

CASES = [  # d, d_ff, E, k, shared, (G, S, d), fold, capacity factor
    (32, 64, 8, 2, False, (3, 16, 32), 5, 8.0),
    (32, 64, 8, 1, True, (3, 16, 32), 5, 8.0),
    (16, 32, 4, 2, True, (2, 32, 16), 9, 1.25),
    (16, 32, 16, 2, False, (2, 40, 16), 11, 4.0),
]
DROPS = [  # capacity factors under which experts overflow
    (16, 32, 16, 2, False, (2, 40, 16), 11, 1.25),
    (16, 32, 4, 1, False, (1, 64, 16), 7, 0.25),
    (16, 32, 4, 2, True, (2, 64, 16), 12, 0.5),
]


def _ids(cases):
    return [f"E{c[2]}k{c[3]}{'s' if c[4] else ''}cf{c[7]}" for c in cases]


@pytest.mark.parametrize("case", CASES + DROPS, ids=_ids(CASES + DROPS))
def test_route_and_capacity_equal_jax(case):
    d, f, E, k, shared, shape, fold, cf = case
    p_np, x_np = _inputs(d, f, E, shape, fold, shared)
    jw, jidx, jaux = j_moe._route(jax.tree_util.tree_map(jnp.asarray, p_np),
                                  jnp.asarray(x_np), E, k)
    p, x = _port(p_np, x_np)
    w, idx, aux = moe._route(p, x, E, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)
    S = shape[1]
    assert moe._capacity(S, E, k, cf) == j_moe._capacity(S, E, k, cf)


def test_route_ties_break_toward_the_lower_index():
    """Equal router logits: both packages pick experts 0..k-1, in order."""
    p = {"router": {"w": np.zeros((8, 6), np.float32)}}
    x = np.ones((1, 3, 8), np.float32)
    _, jidx, _ = j_moe._route({"router": {"w": jnp.asarray(p["router"]["w"])}},
                              jnp.asarray(x), 6, 3)
    _, idx, _ = moe._route(params_from_numpy(p, device="cpu"),
                           torch.tensor(x), 6, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy()[0, 0], [0, 1, 2])


def _j_value_and_grad(fn, p_np, x_np):
    def f(p, x):
        y, aux = fn(p, x)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (y, aux)), g = jax.value_and_grad(f, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p_np), jnp.asarray(x_np))
    return np.asarray(y), float(aux), jax.tree_util.tree_leaves(g)


def _t_value_and_grad(fn, p_np, x_np):
    leaves, spec = pytree.tree_flatten(params_from_numpy(p_np, device="cpu"))
    leaves = [t.requires_grad_(True) for t in leaves]
    y, aux = fn(pytree.tree_unflatten(leaves, spec), torch.tensor(x_np))
    grads = torch.autograd.grad((y ** 2).sum() + aux, leaves)
    return y.detach().numpy(), float(aux.detach()), [g.numpy() for g in grads]


def _scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("impl,case", [("einsum", c) for c in CASES + DROPS]
                         + [("sorted", c) for c in CASES],
                         ids=[f"einsum-{i}" for i in _ids(CASES + DROPS)]
                         + [f"sorted-{i}" for i in _ids(CASES)])
def test_moe_matches_jax(impl, case):
    """Outputs, aux, stats and gradients of one layer against the JAX
    package's (the sorted dispatch without overflow, where the two agree
    by design)."""
    d, f, E, k, shared, shape, fold, cf = case
    p_np, x_np = _inputs(d, f, E, shape, fold, shared)
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf)
    jy, jaux, jg = _j_value_and_grad(
        lambda p, x: J_IMPLS[impl](p, x, dt=J_DT, **kw), p_np, x_np)
    y, aux, g = _t_value_and_grad(
        lambda p, x: IMPLS[impl](p, x, dt=DT, **kw), p_np, x_np)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5, atol=1e-5)
    # top-1: the routing weight is w / w, whose derivative is exactly 0
    # and in fp32 a rounding residue of ~1e-5 (different in each
    # package), while the router's true gradient is the aux term's alone
    # (~1e-2): that leaf is held at 1e-5 of the layer's largest |g|
    top = max(float(np.abs(np.asarray(b)).max()) for b in jg)
    paths = [jax.tree_util.keystr(q) for q, _ in
             jax.tree_util.tree_leaves_with_path(p_np)]
    for path, a, b in zip(paths, g, jg):
        b = np.asarray(b)
        if k == 1 and "router" in path:
            assert float(np.abs(a - b).max()) <= 1e-5 * top, path
        else:
            assert _scaled(a, b) <= 1e-5, path
    p, x = _port(p_np, x_np)
    _, _, s = IMPLS[impl](p, x, dt=DT, with_stats=True, **kw)
    _, _, js = J_IMPLS[impl](jax.tree_util.tree_map(jnp.asarray, p_np),
                             jnp.asarray(x_np), dt=J_DT, with_stats=True,
                             **kw)
    for key in ("expert_counts", "routed_counts", "dropped_tokens"):
        np.testing.assert_array_equal(np.asarray(s[key]),
                                      np.asarray(js[key]))
    assert s["capacity"] == js["capacity"]
    assert (int(s["dropped_tokens"]) > 0) == (case in DROPS)
    rs = moe.routing_stats(p, x, **kw)
    j_rs = j_moe.routing_stats(jax.tree_util.tree_map(jnp.asarray, p_np),
                               x_np, **kw)
    for key in ("expert_counts", "routed_counts"):
        np.testing.assert_array_equal(rs[key], j_rs[key])
    assert (rs["dropped_tokens"], rs["capacity"]) == \
        (j_rs["dropped_tokens"], j_rs["capacity"])


# --- the sorted dispatch under overflow -------------------------------------

OVERFLOW = (16, 32, 4, 2, False, (1, 64, 16), 13, 0.5)   # C = 16


def _kept_oracle(p, x, E, k, kept):
    """The oracle restricted to the kept (token, choice) pairs."""
    w, idx, _ = moe._route(p, x, E, k)
    y = torch.zeros_like(x)
    for (g, s, j) in kept:
        e = int(idx[g, s, j])
        gg, u = x[g, s] @ p["w_gate"][e], x[g, s] @ p["w_up"][e]
        y[g, s] += w[g, s, j] * ((torch.nn.functional.silu(gg) * u)
                                 @ p["w_down"][e])
    return y


def _sorted_kept(idx, E, k, C):
    """The first ``C`` (token, choice) pairs of each expert in token order:
    what a sorted dispatch that loses nothing keeps.  Also each expert's
    routed count and its rank-0 token."""
    G, S, _ = idx.shape
    kept, counts, first = set(), np.zeros(E, int), {}
    for g in range(G):
        seen = np.zeros(E, int)
        for s in range(S):
            for j in range(k):
                e = int(idx[g, s, j])
                if seen[e] == 0:
                    first.setdefault(e, (g, s, j))
                if seen[e] < C:
                    kept.add((g, s, j))
                seen[e] += 1
        counts += seen
    return kept, counts, first


def test_reference_sorted_loses_rank0_tokens_under_overflow():
    """The JAX package's ``moe_sorted`` under overflow: its bucket scatter
    writes the empty index over slot 0 of each overflowing expert, so that
    expert's rank-0 token loses its contribution and every other token
    matches the oracle of the kept pairs; ``with_stats`` still reports
    ``min(count, C)`` kept an expert (ROADMAP queue 3)."""
    d, f, E, k, shared, shape, fold, cf = OVERFLOW
    p_np, x_np = _inputs(d, f, E, shape, fold, shared)
    p, x = _port(p_np, x_np)
    C = moe._capacity(shape[1], E, k, cf)
    with torch.no_grad():
        _, idx, _ = moe._route(p, x, E, k)
        kept, counts, first = _sorted_kept(idx, E, k, C)
        want = _kept_oracle(p, x, E, k, kept).numpy()
        lost = {first[e] for e in range(E) if counts[e] > C}
        without = _kept_oracle(p, x, E, k, kept - lost).numpy()
    assert (counts > C).all() and len(lost) == E
    jy, _, js = j_moe.moe_sorted(jax.tree_util.tree_map(jnp.asarray, p_np),
                                 jnp.asarray(x_np), n_experts=E, top_k=k,
                                 capacity_factor=cf, dt=J_DT,
                                 with_stats=True)
    jy = np.asarray(jy)
    off = np.abs(jy - want).max(-1) > 1e-4
    assert sorted(zip(*np.nonzero(off))) == sorted({(g, s) for g, s, _ in
                                                    lost})
    np.testing.assert_allclose(jy, without, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(js["expert_counts"]),
                                  np.minimum(counts, C))


def test_port_sorted_keeps_min_count_capacity():
    """The port's ``moe_sorted`` under the same overflow keeps exactly
    ``min(count, C)`` pairs an expert, the first in token order, and each
    token's output is the oracle's over its kept pairs."""
    d, f, E, k, shared, shape, fold, cf = OVERFLOW
    p, x = _port(*_inputs(d, f, E, shape, fold, shared))
    C = moe._capacity(shape[1], E, k, cf)
    with torch.no_grad():
        _, idx, _ = moe._route(p, x, E, k)
        kept, counts, _ = _sorted_kept(idx, E, k, C)
        bucket_tok, slot_bucket, routed = moe._sorted_buckets(idx, E, k, C)
        y, _, s = moe.moe_sorted(p, x, n_experts=E, top_k=k,
                                 capacity_factor=cf, dt=DT, with_stats=True)
        want = _kept_oracle(p, x, E, k, kept)
    S = shape[1]
    filled = (bucket_tok < S).sum(-1)[0].numpy()
    np.testing.assert_array_equal(filled, np.minimum(counts, C))
    np.testing.assert_array_equal(routed[0].numpy(), counts)
    np.testing.assert_array_equal(s["expert_counts"].numpy(),
                                  np.minimum(counts, C))
    assert int((slot_bucket < E * C).sum()) == len(kept)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
