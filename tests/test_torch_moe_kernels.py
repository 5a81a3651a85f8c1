"""The plain versions of the MoE layer's kernels (``kernels/moe.py``,
``kernels/dense.py::expert_*_plain``) against the JAX package's
``repro.models.moe`` on the CPU, at ``test_torch_moe.py``'s ``CASES`` and
``DROPS`` (experts that overflow their capacity included), fp32:

* routing: the choices equal, the weights and the softmax within 1e-5, and
  the vjp of the weights and of the aux loss (the kernels' ``dprobs =
  daux E ce / (G S)``) against ``jax.vjp`` of ``_route`` within 1e-5 of each
  leaf's max (top-1: the aux term's alone, the weight being w / w);
* slots and dispatch: the one-hot dispatch tensor that the slots imply
  equal to the reference's, the buckets equal to its dispatch einsum's
  (moved expert-major), the dispatch's vjp within 1e-6;
* combine: against the reference's combine tensor and einsum, forward and
  vjp (rows and weights) within 1e-5;
* the experts' products against ``jax.vjp`` of the einsum, 1e-5;
* the expert-major gather form composed of them (``models/moe.py::
  _experts_major`` after ``_route``) against ``moe_einsum``: outputs, aux,
  stats and every gradient leaf at ``test_torch_moe.py``'s tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import (CASES, DROPS, DT, J_DT, _ids, _inputs, _port,
                            _scaled, _t_value_and_grad)

from repro.models import moe as j_moe
from repro_torch.kernels import dense as dn
from repro_torch.kernels import moe as mk
from repro_torch.models import moe

ALL = CASES + DROPS


def _j_dispatch(idx, weights, E, k, C):
    """The reference's one-hot dispatch and combine tensors (G, S, E, C),
    as ``repro.models.moe.moe_einsum`` builds them."""
    G = idx.shape[0]
    dispatch = jnp.zeros(idx.shape[:2] + (E, C), jnp.float32)
    combine = jnp.zeros(idx.shape[:2] + (E, C), jnp.float32)
    prior = jnp.zeros((G, E), jnp.int32)
    for i in range(k):
        mask_i = jax.nn.one_hot(idx[..., i], E, dtype=jnp.int32)
        pos_i = jnp.cumsum(mask_i, axis=1) - 1 + prior[:, None, :]
        prior = prior + jnp.sum(mask_i, axis=1)
        keep = (pos_i < C) & (mask_i > 0)
        oh_pos = jax.nn.one_hot(jnp.where(keep, pos_i, C), C + 1,
                                dtype=jnp.float32)[..., :C]
        d_i = oh_pos * keep.astype(jnp.float32)[..., None]
        dispatch = dispatch + d_i
        combine = combine + d_i * weights[..., i, None, None]
    return dispatch, combine


@functools.lru_cache(maxsize=None)
def _case_inputs(case):
    """The JAX package's init and inputs of a case, made once a case."""
    d, f, E, k, shared, shape, fold, cf = case
    return _inputs(d, f, E, shape, fold, shared)


def _case(case):
    d, f, E, k, shared, shape, fold, cf = case
    p_np, x_np = _case_inputs(case)
    C = moe._capacity(shape[1], E, k, cf)
    return p_np, x_np, E, k, C


def _j_value_and_grad(fn, p_np, x_np):
    """``test_torch_moe.py``'s, under jit (one compilation a case)."""
    def f(p, x):
        y, aux = fn(p, x)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (y, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p_np), jnp.asarray(x_np))
    return np.asarray(y), float(aux), jax.tree_util.tree_leaves(g)


def _expert_major(t, G, E, C):
    """(G, E, C, d) -> (E, G C, d)."""
    return np.moveaxis(np.asarray(t), 1, 0).reshape(E, G * C, -1)


@pytest.mark.parametrize("case", ALL, ids=_ids(ALL))
def test_route_plain_matches_jax(case):
    p_np, x_np, E, k, C = _case(case)
    w_np = p_np["router"]["w"]
    G, S, _ = x_np.shape

    def j_route(x, w):
        weights, _, aux = j_moe._route({"router": {"w": w}}, x, E, k)
        return weights, aux

    # under jit: one compilation, not one a primitive
    (jw, jaux), vjp = jax.vjp(jax.jit(j_route), jnp.asarray(x_np),
                              jnp.asarray(w_np))
    jidx = jax.jit(lambda x, w: j_moe._route({"router": {"w": w}}, x, E,
                                             k)[1])(jnp.asarray(x_np),
                                                    jnp.asarray(w_np))
    x, w = torch.tensor(x_np), torch.tensor(w_np)
    weights, idx, probs = mk.route_plain(x, w, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(weights.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)
    j_probs = jax.nn.softmax(jnp.asarray(x_np) @ jnp.asarray(w_np), axis=-1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs),
                               rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(case[6])
    # top-1: the weight is w / w, whose derivative is 0 and in each package
    # a rounding residue of the cotangent's size x 1e-7: the aux term alone
    dweights = rng.standard_normal(weights.shape).astype(np.float32) \
        * (k > 1)
    daux = np.float32(0.7)
    jdx, jdw = vjp((jnp.asarray(dweights), jnp.asarray(daux)))
    # the aux loss E sum_e mean(probs_e) ce_e, and the vjp of the weights
    # and of it
    np.testing.assert_allclose(float(mk.aux_plain(probs, idx, E)),
                               float(jaux), rtol=1e-5)
    dx, dw = mk.route_bwd_plain(torch.tensor(dweights), torch.tensor(daux),
                                x, w, k)
    for a, b in ((dx, jdx), (dw, jdw)):
        assert _scaled(a.numpy(), np.asarray(b)) <= 1e-5


@pytest.mark.parametrize("case", ALL, ids=_ids(ALL))
def test_slots_dispatch_and_combine_plain_match_jax(case):
    p_np, x_np, E, k, C = _case(case)
    G, S, d = x_np.shape
    x = torch.tensor(x_np)
    weights, idx, _ = mk.route_plain(x, torch.tensor(p_np["router"]["w"]), k)
    jd, jc = jax.jit(_j_dispatch, static_argnums=(2, 3, 4))(
        jnp.asarray(idx.numpy()), jnp.asarray(weights.numpy()), E, k, C)
    choice_slot, slot_src, routed = mk.slots_plain(idx, E, C)
    # the one-hot dispatch tensor the slots imply
    onehot = np.zeros((G, S, E, C), np.float32)
    for g, s, i in zip(*np.nonzero(choice_slot.numpy() >= 0)):
        slot = int(choice_slot[g, s, i])
        e, rest = divmod(slot, G * C)
        assert rest // C == g and int(slot_src.reshape(-1)[slot]) == \
            (g * S + s) * k + i
        onehot[g, s, e, rest % C] = 1.0
    np.testing.assert_array_equal(onehot, np.asarray(jd))
    np.testing.assert_array_equal(routed.sum(0).numpy(), np.asarray(
        jax.nn.one_hot(jnp.asarray(idx.numpy()), E).sum((0, 1, 2))))
    assert (int((choice_slot < 0).sum()) > 0) == (case in DROPS)

    # dispatch: the reference's einsum, moved expert-major; and its vjp
    j_in, j_vjp = jax.vjp(jax.jit(lambda t: jnp.einsum("gsd,gsec->gecd", t,
                                                       jd)),
                          jnp.asarray(x_np))
    buckets = mk.dispatch_plain(x, slot_src, k)
    np.testing.assert_array_equal(buckets.numpy(),
                                  _expert_major(j_in, G, E, C))
    rng = np.random.default_rng(case[6] + 1)
    dexp = rng.standard_normal((G, E, C, d)).astype(np.float32)
    (jdx,) = j_vjp(jnp.asarray(dexp))
    dx = mk.dispatch_bwd_plain(
        torch.tensor(_expert_major(dexp, G, E, C)), choice_slot)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-6,
                               atol=1e-6)

    # combine: the reference's combine tensor built from the weights, and
    # its einsum; vjp in the expert outputs and the weights
    def j_combine(out, wts):
        return jnp.einsum("gecd,gsec->gsd", out,
                          _j_dispatch(jnp.asarray(idx.numpy()), wts, E, k,
                                      C)[1])

    out = rng.standard_normal((G, E, C, d)).astype(np.float32)
    jy, c_vjp = jax.vjp(jax.jit(j_combine), jnp.asarray(out),
                        jnp.asarray(weights.numpy()))
    rows = torch.tensor(_expert_major(out, G, E, C)).requires_grad_(True)
    wts = weights.detach().clone().requires_grad_(True)
    y = mk.combine_plain(rows, wts, choice_slot, torch.float32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    dy = rng.standard_normal((G, S, d)).astype(np.float32)
    j_drows, j_dw = c_vjp(jnp.asarray(dy))
    drows, dwts = mk.combine_bwd_plain(torch.tensor(dy), rows.detach(),
                                       wts.detach(), choice_slot, slot_src)
    assert _scaled(drows.numpy(), _expert_major(j_drows, G, E, C)) <= 1e-5
    assert _scaled(dwts.numpy(), np.asarray(j_dw)) <= 1e-5
    # and the same from autograd over the plain combine
    a_rows, a_w = torch.autograd.grad(y, (rows, wts), torch.tensor(dy))
    assert _scaled(a_rows.numpy(), drows.numpy()) <= 1e-6
    assert _scaled(a_w.numpy(), dwts.numpy()) <= 1e-6


def test_expert_products_plain_match_jax():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 24, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 16, 40)) * 0.25).astype(np.float32)
    dy = rng.standard_normal((3, 24, 40)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, b: jnp.einsum("ecd,edf->ecf", a, b),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    xt, wt = torch.tensor(x), torch.tensor(w)
    assert _scaled(dn.expert_fwd_plain(xt, wt).numpy(), np.asarray(jy)) \
        <= 1e-5
    dx, dw = dn.expert_bwd_plain(torch.tensor(dy), xt, wt)
    assert _scaled(dx.numpy(), np.asarray(jdx)) <= 1e-5
    assert _scaled(dw.numpy(), np.asarray(jdw)) <= 1e-5


def _gathered(p, x, *, n_experts, top_k, capacity_factor, dt,
              with_stats=False):
    """``moe_einsum`` as the card computes it: ``_route``, then the
    expert-major gather form (here through the plain versions)."""
    G, S, d = x.shape
    weights, idx, aux = moe._route(p, x, n_experts, top_k)
    C = moe._capacity(S, n_experts, top_k, capacity_factor)
    y, routed = moe._experts_major(p, x, weights, idx, n_experts, C, "silu",
                                   dt)
    if "shared" in p:
        y = y + moe.mlp(p["shared"], x, act="silu", dt=dt)
    if with_stats:
        return y, aux, moe._stats(routed.sum(0),
                                  torch.clamp(routed, max=C).sum(0), C)
    return y, aux


@pytest.mark.parametrize("case", ALL, ids=_ids(ALL))
def test_experts_major_matches_jax_moe_einsum(case):
    """Outputs, aux, stats and every gradient leaf of the gather form
    against the JAX package's ``moe_einsum`` (``test_torch_moe.py``'s
    ``test_moe_matches_jax`` tolerances)."""
    d, f, E, k, shared, shape, fold, cf = case
    p_np, x_np = _case_inputs(case)
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf)
    jy, jaux, jg = _j_value_and_grad(
        lambda p, x: j_moe.moe_einsum(p, x, dt=J_DT, **kw), p_np, x_np)
    y, aux, g = _t_value_and_grad(
        lambda p, x: _gathered(p, x, dt=DT, **kw), p_np, x_np)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5, atol=1e-5)
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
    _, _, s = _gathered(p, x, dt=DT, with_stats=True, **kw)
    _, _, js = jax.jit(lambda p, x: j_moe.moe_einsum(
        p, x, dt=J_DT, with_stats=True, **kw))(
            jax.tree_util.tree_map(jnp.asarray, p_np), jnp.asarray(x_np))
    for key in ("expert_counts", "routed_counts", "dropped_tokens"):
        np.testing.assert_array_equal(np.asarray(s[key]),
                                      np.asarray(js[key]))
    assert s["capacity"] == js["capacity"]
