"""The MoE layer's CUDA sources (``csrc/moe.cu``, and ``csrc/dense.cu``
batched over experts) run on the CPU under the emulation of
``tests/_cuda_emu.py`` through their wrappers' card paths, against their
plain versions (``kernels/moe.py::*_plain``, ``dense.py::expert_*_plain``)
at the shapes of ``test_torch_moe.py``'s ``CASES`` and ``DROPS`` (experts
that overflow their capacity included), in fp32 and bf16:

* routing: the choices equal, weights and probs within 1e-5 of their max
  (fp32; 1e-2 in bf16, whose x both read exactly), dx and dW_r within 1e-5
  of their max (bf16 dx 1e-2: one rounding apart);
* slots: ``choice_slot``, ``slot_src`` and the routed counts equal, also
  at ragged capacities (not a multiple of 8); dispatch and its vjp bit for
  bit (the same rows copied, the same fp32 sum of k rows);
* combine: y within 1e-5 of its max (bf16: one rounding), its vjp's rows
  and weights' cotangents within 1e-5;
* the experts' products batched: forward, dx and dw within the dense
  GEMM's tolerances (fp32 2e-4, bf16 3e-2), at ragged shapes;
* two calls of every kernel bit for bit;
* ``moe_einsum`` and ``moe_sorted`` through the kernels against the CPU
  layer (the one-hot einsums, their plain version) in fp32, outputs, aux,
  stats and gradients within 1e-5 of their max, each kernel launched once
  each way; the limits (E, k) refused.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import body_step_ops
from _cuda_emu import (_np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)
from test_torch_moe import CASES, DROPS, _ids
from torch.utils import _pytree as pytree

from repro_torch.kernels import build
from repro_torch.kernels import dense as dn
from repro_torch.kernels import moe as mk
from repro_torch.models import moe
from repro_torch.models.layers import DTypes

F32, BF16 = torch.float32, torch.bfloat16
KERNELS = (mk.moe_route, mk.moe_route_bwd, mk.moe_slots, mk.moe_dispatch,
           mk.moe_dispatch_bwd, mk.moe_combine, mk.moe_combine_bwd,
           dn.expert_fwd, dn.expert_bwd)


def _t(rng, shape, dtype=F32, scale=1.0):
    return torch.tensor(_np(rng, shape, scale)).to(dtype)


def _routed(case, dtype, seed):
    """x (G, S, d), the router weight and the plain routing of a case (its
    choices contiguous, as the routing kernel writes them: the kernels'
    wrappers take no other layout)."""
    d, f, E, k, shared, shape, fold, cf = case
    rng = np.random.default_rng(seed)
    x = _t(rng, shape, dtype)
    w = _t(rng, (d, E), F32, d ** -0.5)
    weights, idx, probs = mk.route_plain(x, w, k)
    return rng, x, w, (weights, idx.contiguous(), probs)


# the router weight's position among the parameter leaves (sorted keys)
ROUTER_LEAF = 0


def _counts():
    return [fn.launches for fn in KERNELS]


ALL = CASES + DROPS


def _check_route(case, dtype, twice):
    d, f, E, k, shared, shape, fold, cf = case
    rng, x, w, (want_w, want_idx, want_p) = _routed(case, dtype, fold)
    weights, idx, probs, aux, ce = mk.moe_route(x, w, k)
    assert torch.equal(idx, want_idx)
    tol = 1e-5 if dtype == F32 else 1e-2
    assert scaled_err(weights, want_w) <= tol
    assert scaled_err(probs, want_p) <= tol
    # the aux loss computed in the routing kernel: its value, its ce, and
    # a running total's sum (one fp32 add)
    assert scaled_err(aux, mk.aux_plain(want_p, want_idx, E)) <= tol
    assert torch.equal(ce, torch.nn.functional.one_hot(idx, E).float()
                       .sum(2).mean(dim=(0, 1)))
    aux_in = _t(rng, (), F32)
    assert bits_equal(mk.moe_route(x, w, k, aux_in=aux_in)[3], aux_in + aux)
    dweights = _t(rng, weights.shape)
    daux = _t(rng, (), F32, 10.0)
    dx, dw = mk.moe_route_bwd(dweights, daux, x, w, probs, idx, ce)
    want_dx, want_dw = mk.route_bwd_plain(dweights, daux, x, w, k)
    assert dx.dtype == dtype and dw.dtype == F32
    assert scaled_err(dx, want_dx) <= tol and scaled_err(dw, want_dw) <= 1e-5
    # the weights' cotangent alone (an unread aux; at top-1 the weight is
    # w / w, whose derivative is 0 and in the plain version a rounding
    # residue: held at the scale of the whole cotangent's gradient)
    dx1, dw1 = mk.moe_route_bwd(dweights, None, x, w, probs, idx, ce)
    want1 = mk.route_bwd_plain(dweights, None, x, w, k)
    for got, ref, full, t in ((dx1, want1[0], want_dx, tol),
                              (dw1, want1[1], want_dw, 1e-5)):
        scale = max(float(ref.abs().max()), float(full.abs().max()))
        assert float((got.float() - ref.float()).abs().max()) <= t * scale
    if twice:
        again = mk.moe_route(x, w, k)
        assert all(bits_equal(a, b) for a, b in zip(
            again, (weights, idx, probs, aux, ce)))
        assert all(bits_equal(a, b) for a, b in zip(
            mk.moe_route_bwd(dweights, daux, x, w, probs, idx, ce),
            (dx, dw)))


def _check_slots_dispatch(case, dtype, d_pad, twice):
    """The slots at the case's capacity and at a ragged one (below it, not
    a multiple of 8: more drops); dispatch and its vjp bit for bit, with a
    row width that takes the element loops where ``d_pad`` is odd."""
    d, f, E, k, shared, shape, fold, cf = case
    G, S, _ = shape
    rng, _, w, (_, idx, _) = _routed(case, F32, fold)
    x = _t(rng, (G, S, d + d_pad), dtype)
    for C in (moe._capacity(S, E, k, cf), max(1, S * k // E // 2 - 1)):
        got = mk.moe_slots(idx, E, C)
        want = mk.slots_plain(idx, E, C)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), C
        choice_slot, slot_src, routed = got
        assert int(routed.sum()) == G * S * k
        kept = int((choice_slot >= 0).sum())
        assert kept == int(torch.clamp(routed, max=C).sum())
        assert kept == int((slot_src >= 0).sum())
        buckets = mk.moe_dispatch(x, slot_src, k)
        assert buckets.shape == (E, G * C, d + d_pad)
        assert bits_equal(buckets, mk.dispatch_plain(x, slot_src, k))
        dexp = _t(rng, buckets.shape, dtype)
        dx = mk.moe_dispatch_bwd(dexp, choice_slot)
        assert bits_equal(dx, mk.dispatch_bwd_plain(dexp, choice_slot))
        if twice:
            assert all(bits_equal(a, b) for a, b in
                       zip(mk.moe_slots(idx, E, C), got))
            assert bits_equal(buckets, mk.moe_dispatch(x, slot_src, k))
            assert bits_equal(dx, mk.moe_dispatch_bwd(dexp, choice_slot))


def _check_combine(case, rows_dt, y_dt, d_pad, twice):
    d, f, E, k, shared, shape, fold, cf = case
    G, S, _ = shape
    d = d + d_pad
    rng, _, _, (weights, idx, _) = _routed(case, F32, fold)
    C = moe._capacity(S, E, k, cf)
    choice_slot, slot_src, _ = mk.slots_plain(idx, E, C)
    rows = _t(rng, (E, G * C, d), rows_dt)
    y = mk.moe_combine(rows, weights, choice_slot, y_dt)
    want = mk.combine_plain(rows, weights, choice_slot, y_dt)
    assert y.dtype == y_dt
    assert scaled_err(y, want) <= (1e-5 if y_dt == F32 else 1e-2)
    dy = _t(rng, (G, S, d), y_dt)
    drows, dweights = mk.moe_combine_bwd(dy, rows, weights, choice_slot,
                                         slot_src)
    want_rows, want_w = mk.combine_bwd_plain(dy, rows, weights, choice_slot,
                                             slot_src)
    assert drows.dtype == rows_dt and dweights.dtype == F32
    assert scaled_err(drows, want_rows) <= (1e-5 if rows_dt == F32
                                            else 1e-2)
    assert scaled_err(dweights, want_w) <= 1e-5
    # a dropped choice and an empty slot give exact zeros
    assert bool((dweights[choice_slot < 0] == 0).all())
    assert bool((drows.reshape(-1, d)[slot_src.reshape(-1) < 0] == 0).all())
    if twice:
        assert bits_equal(y, mk.moe_combine(rows, weights, choice_slot,
                                            y_dt))
        assert all(bits_equal(a, b) for a, b in zip(
            mk.moe_combine_bwd(dy, rows, weights, choice_slot, slot_src),
            (drows, dweights)))


@pytest.mark.parametrize("case", ALL, ids=_ids(ALL))
def test_kernels_at_case(kernels_on_card, case):
    """Each kernel once at the case's shape in fp32 against its plain
    version; where experts overflow, each also twice, bit for bit."""
    twice = case in DROPS
    _check_route(case, F32, twice)
    _check_slots_dispatch(case, F32, 0, twice)
    _check_combine(case, F32, F32, 0, twice)


@pytest.mark.parametrize("case,y_dt,d_pad", [
    (DROPS[1], BF16, 0), (DROPS[2], F32, 3), (DROPS[2], BF16, 5)],
    ids=["top1-bf16", "bf16-rows-fp32-y-ragged-d", "bf16-ragged-d"])
def test_kernels_bf16(kernels_on_card, case, y_dt, d_pad):
    """The routing, the slots, the dispatch and the combine on bf16 rows
    (the combine into bf16 and into fp32), with row widths that take the
    element loops, twice each."""
    _check_route(case, BF16, True)
    _check_slots_dispatch(case, BF16, d_pad, True)
    _check_combine(case, BF16, y_dt, d_pad, True)


@pytest.mark.parametrize("E,M,K,N,x_dt,w_dt", [
    (2, 37, 24, 37, BF16, F32),     # N odd: element loads
    (2, 40, 40, 136, BF16, BF16),   # 16-byte loads; N = 128 + 8
    (3, 33, 20, 40, F32, BF16),     # the SIMT fp32 product
])
def test_expert_products_kernel_source(kernels_on_card, E, M, K, N, x_dt,
                                       w_dt):
    rng = np.random.default_rng(E * M + N)
    x = _t(rng, (E, M, K), x_dt)
    w = _t(rng, (E, K, N), F32, K ** -0.5).to(w_dt)
    dy = _t(rng, (E, M, N), x_dt)
    y = dn.expert_fwd(x, w)
    dx, dw = dn.expert_bwd(dy, x, w)
    tol = 3e-2 if x_dt == BF16 else 2e-4
    assert y.dtype == x_dt and dx.dtype == x_dt and dw.dtype == w_dt
    assert (y.shape, dx.shape, dw.shape) == ((E, M, N), (E, M, K),
                                             (E, K, N))
    want = (dn.expert_fwd_plain(x, w), *dn.expert_bwd_plain(dy, x, w))
    for got, ref in zip((y, dx, dw), want):
        # each expert at the tolerance of its own scale
        for e in range(E):
            assert scaled_err(got[e], ref[e]) <= tol, e
    assert bits_equal(y, dn.expert_fwd(x, w))
    assert all(bits_equal(a, b) for a, b in zip(dn.expert_bwd(dy, x, w),
                                                (dx, dw)))


def _layer(p_np, x_np, impl, kw):
    leaves, spec = pytree.tree_flatten(pytree.tree_map(torch.tensor, p_np))
    leaves = [t.requires_grad_(True) for t in leaves]
    x = torch.tensor(x_np).requires_grad_(True)
    fn = {"einsum": moe.moe_einsum, "sorted": moe.moe_sorted}[impl]
    y, aux, stats = fn(pytree.tree_unflatten(leaves, spec), x,
                       dt=DTypes(compute=F32), with_stats=True, **kw)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    grads = torch.autograd.grad((y * g).sum() + aux, [x, *leaves])
    return y.detach(), aux.detach(), stats, grads


def _params(case, seed):
    d, f, E, k, shared, shape, fold, cf = case
    rng = np.random.default_rng(seed)
    p = {"router": {"w": _np(rng, (d, E), d ** -0.5)},
         "w_gate": _np(rng, (E, d, f), d ** -0.5),
         "w_up": _np(rng, (E, d, f), d ** -0.5),
         "w_down": _np(rng, (E, f, d), f ** -0.5)}
    if shared:
        p["shared"] = {n: {"w": _np(rng, dims, dims[0] ** -0.5)}
                       for n, dims in (("gate", (d, f)), ("up", (d, f)),
                                       ("down", (f, d)))}
    return p, _np(rng, shape)


@pytest.mark.parametrize("impl,case", [
    ("einsum", DROPS[1]), ("einsum", DROPS[2]), ("sorted", CASES[2])],
    ids=["einsum-top1-drops", "einsum-E4s-drops", "sorted-E4s"])
def test_moe_layer_through_the_kernels(kernels_on_card, monkeypatch, impl,
                                       case):
    """The layer with every wrapper on its card path (emulated) against the
    CPU layer (its one-hot einsums) in fp32, each kernel launched once each
    way (the sorted dispatch: the routing and the experts' products)."""
    d, f, E, k, shared, shape, fold, cf = case
    p_np, x_np = _params(case, fold)
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf)
    before = _counts()
    got = _layer(p_np, x_np, impl, kw)
    launched = [a - b for a, b in zip(_counts(), before)]
    if impl == "einsum":
        assert launched == [1, 1, 1, 1, 1, 1, 1, 3, 3]
    else:
        assert launched == [1, 1, 0, 0, 0, 0, 0, 3, 3]
    monkeypatch.setattr(build, "on_card", lambda t: False)
    want = _layer(p_np, x_np, impl, kw)
    assert scaled_err(got[0], want[0]) <= 1e-5
    assert abs(float(got[1]) - float(want[1])) <= 1e-6
    for key in ("expert_counts", "routed_counts", "dropped_tokens"):
        assert torch.equal(got[2][key], want[2][key]), key
    assert (int(got[2]["dropped_tokens"]) > 0) == (case in DROPS)
    # top-1: the routing weight is w / w, whose derivative is 0 and a
    # rounding residue in each version; the router's gradient is the aux
    # term's alone, held at 1e-5 of the layer's largest |g|
    # (test_torch_moe.py's rule)
    top = max(float(b.abs().max()) for b in want[3])
    for i, (a, b) in enumerate(zip(got[3], want[3])):
        if k == 1 and i == 1 + ROUTER_LEAF:
            assert float((a - b).abs().max()) <= 1e-5 * top
        else:
            assert scaled_err(a, b) <= 1e-5, i


def test_routing_stats_through_the_kernels(kernels_on_card):
    case = DROPS[2]
    d, f, E, k, shared, shape, fold, cf = case
    p_np, x_np = _params(case, fold)
    p = {"router": {"w": torch.tensor(p_np["router"]["w"])}}
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf)
    before = mk.moe_slots.launches
    got = moe.routing_stats(p, torch.tensor(x_np), **kw)
    assert mk.moe_slots.launches == before + 1
    x, w = torch.tensor(x_np), p["router"]["w"]
    _, idx, _ = mk.route_plain(x, w, k)
    C = moe._capacity(shape[1], E, k, cf)
    routed = mk.slots_plain(idx, E, C)[2]
    np.testing.assert_array_equal(got["routed_counts"],
                                  routed.sum(0).numpy())
    np.testing.assert_array_equal(
        got["expert_counts"], torch.clamp(routed, max=C).sum(0).numpy())
    assert got["dropped_tokens"] > 0 and got["capacity"] == C


def test_moe_kernels_refuse(kernels_on_card):
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="experts"):
        mk.moe_route(x, torch.zeros((8, 65)), 2)
    with pytest.raises(ValueError, match="choices"):
        mk.moe_route(x, torch.zeros((8, 16)), 9)
    with pytest.raises(ValueError, match="float64"):
        mk.moe_route(x.double(), torch.zeros((8, 16)), 2)
    with pytest.raises(ValueError, match="choices"):
        mk.moe_slots(torch.zeros((1, 4, 3), dtype=torch.int64), 2, 8)
    with pytest.raises(ValueError, match="int32"):
        mk.dispatch(x, torch.zeros((1, 4, 2)), torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="w must be"):
        dn.expert_fwd(torch.zeros((2, 4, 8)), torch.zeros((3, 8, 5)))



@pytest.mark.parametrize("dtype,d_pad", [(F32, 0), (BF16, 0), (BF16, 3)],
                         ids=["fp32", "bf16", "bf16-ragged-d"])
def test_combine_residual_and_dispatch_readers(kernels_on_card, dtype,
                                               d_pad):
    """The combine's residual epilogue and the dispatch backward's second
    cotangent, bit for bit the plain adds they replace (``res + y``, and
    the buckets' cotangents summed before the gather-sum), in the vector
    and the element loops; through the autograd functions the residual's
    cotangent is ``dy`` and the two readers' gradient the summed one's."""
    case = DROPS[2]
    d, f, E, k, shared, shape, fold, cf = case
    G, S, _ = shape
    d = d + d_pad
    rng, _, _, (weights, idx, _) = _routed(case, F32, fold)
    C = moe._capacity(S, E, k, cf)
    choice_slot, slot_src, _ = mk.slots_plain(idx, E, C)
    rows = _t(rng, (E, G * C, d), dtype)
    res = _t(rng, (G, S, d), dtype)
    y = mk.moe_combine(rows, weights, choice_slot, dtype, res)
    assert bits_equal(y, res + mk.moe_combine(rows, weights, choice_slot,
                                              dtype))
    dexp, dexp2 = _t(rng, rows.shape, dtype), _t(rng, rows.shape, dtype)
    assert bits_equal(mk.moe_dispatch_bwd(dexp, choice_slot, dexp2),
                      mk.moe_dispatch_bwd(dexp + dexp2, choice_slot))

    x = _t(rng, (G, S, d), dtype).requires_grad_(True)
    a, b = mk.dispatch(x, choice_slot, slot_src, n=2)
    assert bits_equal(a, b) and bits_equal(a, mk.moe_dispatch(x, slot_src,
                                                              k))
    (dx,) = torch.autograd.grad((a, b), x, (dexp, dexp2))
    assert bits_equal(dx, mk.moe_dispatch_bwd(dexp + dexp2, choice_slot))
    r = res.clone().requires_grad_(True)
    dy = _t(rng, (G, S, d), dtype)
    (dr,) = torch.autograd.grad(
        mk.combine(rows, weights, choice_slot, slot_src, dtype, r), r, dy)
    assert bits_equal(dr, dy)

# the batch and length of the token-axis count: neither is a width of the
# SMOKE decoder, so a tensor that leads with them runs over the tokens
OPS_B, OPS_S = 3, 40


def test_phi35_card_step_touches_no_token_axis(emulated_libs,
                                               kernels_on_card, monkeypatch):
    """One chain step of phi3.5-moe-42b's SMOKE body on the emulated card, and
    its vjp, under a ``TorchDispatchMode``: no ATen compute operator (an
    allocation or a view aside) has an output with a token axis -- every
    residual add, cotangent sum, table and aux-loss reduction of the body
    is inside a hand-written kernel or gone."""
    emulated_libs.prebuild(["flash_attention", "flash_attention_bwd", "rmsnorm", "rope", "dense", "moe"])
    assert body_step_ops("phi3.5-moe-42b", 1, OPS_B, OPS_S,
                         monkeypatch) == []
