"""The fused segment kernels' CUDA source (``csrc/segment_fused.cu``, with
the step loop of ``csrc/lstm_cell.cu``) run on the CPU under the emulation
of ``tests/_cuda_emu.py``: the advance and the reverse against their plain
versions and each other, the reverse's kernels one by one, the front
door's fused runner end to end, and the captured segments (each graph
replay runs its launches again here) against the uncaptured ones, bit for
bit, with the argument block's step offsets and Level-2 slots.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (T_BODY, V, _np, _ptr, _segment,  # noqa: F401
                       card_paths, emulated_libs)

from repro_torch import api
from repro_torch.core.schedule import chunk_length
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import segment_fused as sf
from repro_torch.models import lstm

@pytest.mark.parametrize("T,chunk,Bn", [
    (23, 5, 5),    # uneven chunk tail; a ragged second row block
    (21, 5, 3),    # length-1 tail (merged forward, its own chunk reversed)
    (6, 6, 4),     # one chunk
    (1, 4, 3),     # one step
    (4, 9, 2),     # chunk > T: one chunk of T steps
    (9, 4, 2),     # two chunks, the second of chunk + 1 steps (merged tail)
])
def test_fused_segment_kernel_sources(card_paths, T, chunk, Bn):
    params, carry, xs, dcarry = _segment(T, Bn, seed=T)
    out = sf.fused_advance_segment(T_BODY, params, carry, xs, None,
                                   chunk=chunk)
    ref = sf.advance_plain(T_BODY, params, carry, xs, None, chunk=chunk)
    for a, b in zip(list(out.carry) + list(out.boundaries),
                    list(ref.carry) + list(ref.boundaries)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dc, dp, dxd = sf.fused_reverse_segment(
        T_BODY, (False, False), params, carry, xs, None, dcarry, chunk=chunk)
    rdc, rdp, _ = sf.reverse_plain(T_BODY, (False, False), params, carry, xs,
                                   None, dcarry, chunk=chunk)
    assert dxd == []
    for a, b in zip(dc, rdc):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for k in rdp:
        torch.testing.assert_close(
            dp[k], rdp[k], rtol=1e-4,
            atol=1e-4 * max(float(rdp[k].abs().max()), 1e-6))


def _advance_against_step_loop(T, chunk, Bn, seed, token_steps):
    """The fused advance's chunk-entry boundaries and exit (h, c) are, bit
    for bit, the states of one run of the step loop (``token_steps``) over
    the whole segment from the same entry; two calls give the same bits,
    the loss accumulator and its boundaries included."""
    params, carry, (tok, tgt), _ = _segment(T, Bn, seed)
    adv = sf.fused_advance_segment
    before = (lc.lstm_cell.launches, adv.cell_launches, adv.cell_steps)
    outs = [adv(T_BODY, params, carry, (tok, tgt), None, chunk=chunk)
            for _ in range(2)]
    nc = len(sf.forward_bounds(T, chunk)) - 1   # one step loop a chunk
    assert (lc.lstm_cell.launches, adv.cell_launches, adv.cell_steps) == (
        before[0] + 2 * nc, before[1] + 2 * nc, before[2] + 2 * T)
    for out in outs:
        out.ready.synchronize()
    a, b = [list(o.carry) + list(o.boundaries) for o in outs]
    assert all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
    h0, c0, _ = carry
    hs = torch.empty((T + 1,) + tuple(h0.shape), device=h0.device)
    cs = torch.empty_like(hs)
    hs[0], cs[0] = h0, c0
    token_steps(tok, params["emb"], hs, cs, params["w"], params["b"])
    starts = sf.forward_bounds(T, chunk)[:-1]
    out = outs[0]
    assert torch.equal(out.boundaries[0], hs[starts].cpu())
    assert torch.equal(out.boundaries[1], cs[starts].cpu())
    assert torch.equal(out.carry[0], hs[T]) and torch.equal(out.carry[1],
                                                            cs[T])


@pytest.mark.parametrize("T,chunk,Bn", [
    (23, 5, 5),    # uneven chunk tail
    (21, 5, 3),    # a merged length-1 tail: a chunk of chunk + 1 steps
])
def test_fused_advance_equals_the_step_loop(card_paths, T, chunk, Bn):
    _advance_against_step_loop(
        T, chunk, Bn, seed=40 + T,
        token_steps=lambda tok, emb, hs, cs, w, b: lc._token_steps(
            tok, emb, hs, cs, w, b, None, None))


def test_offloaded_gradient_through_the_kernel_sources(card_paths):
    """The front-end's fused runner on the emulated kernels: the dense
    autograd loss and gradients, one launch of each segment kernel per
    segment and direction, and kernel 1's step-loop launches and steps by
    caller as ``segment_fused.cell_work`` counts them from the plan."""
    params, _, _, _ = _segment(1, 1, seed=9)
    tok = torch.tensor(np.random.default_rng(1).integers(0, V, (5, 30)),
                       dtype=torch.int32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = lstm.forward_loss(leaves, tok)
    dense = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    wrappers = {"advance": sf.fused_advance_segment,
                "reverse": sf.fused_reverse_segment}
    before = {k: (f.launches, f.cell_launches, f.cell_steps)
              for k, f in wrappers.items()}
    v, g = api.value_and_grad_offloaded(
        lstm.train_chain(), interval=13, slots=4, runner="fused",
        device="cpu")(params, {"tokens": tok})
    plan = api.last_plan()
    want = {k: [plan.num_segments, 0, 0] for k in wrappers}
    for seg in plan.segments:
        chunk = chunk_length(seg.length, plan.s_l1) or seg.length
        for k, (n, steps) in sf.cell_work(seg.length, chunk).items():
            want[k][1] += n
            want[k][2] += steps
    for k, f in wrappers.items():
        got = (f.launches, f.cell_launches, f.cell_steps)
        assert [a - b for a, b in zip(got, before[k])] == want[k], k
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for k in dense:
        torch.testing.assert_close(g[k], dense[k], rtol=1e-4,
                                   atol=1e-4 * float(dense[k].abs().max()))


def test_fused_advance_level2_entries_own_their_storage(card_paths,
                                                      monkeypatch):
    """Level 2 holds what it counts: every chunk entry of a fused advance
    is an allocation of its own, and each entry the executor stores (the
    kernel's ``entries[0]``, kept without a copy) has storage bytes equal to
    its ``tree_bytes`` — so the store's live bytes are the bytes held."""
    from repro_torch.api.chain import diff_mask
    from repro_torch.core import storage
    from repro_torch.core.compiled_ops import (CompiledChainOps,
                                               FusedSegmentRunner)
    from repro_torch.core.executor import CheckpointExecutor

    params, carry, xs, _ = _segment(31, 4, seed=12)
    out = sf.fused_advance_segment(T_BODY, params, carry, xs, None, chunk=4)
    assert len(out.entries) == len(sf.forward_bounds(31, 4)) - 1 == 8
    for entry in out.entries:
        held = sum(t.untyped_storage().nbytes() for t in entry)
        assert held == storage.tree_bytes(entry)
    handed = []
    real_views = storage._frozen_views

    def views(tree):
        handed.append(tree)
        return real_views(tree)

    monkeypatch.setattr(storage, "_frozen_views", views)
    runner = FusedSegmentRunner(CompiledChainOps(T_BODY, *diff_mask(xs)),
                                params, xs, None, s_l1=4)
    _, run = CheckpointExecutor().multistage_forward(
        carry, 31, interval=12, s_l1=4, runner=runner)
    run.engine.wait_stores()
    assert len(handed) == run.plan.num_segments == 3
    held = [sum(t.untyped_storage().nbytes() for t in tree)
            for tree in handed]
    assert held == [storage.tree_bytes(tree) for tree in handed]
    assert run.engine.backend.live_bytes == sum(held)
    for seg, tree in zip(run.plan.segments, handed):
        stored = run.engine.backend.get(seg.begin)
        assert all(np.shares_memory(a, t.numpy())
                   for a, t in zip(stored, tree))
    run.close()


def test_fused_advance_slice_handover_is_refused(card_paths):
    """The hand-over the Level-2 guard exists for: ``leaf[0]`` of a
    segment's stacked ``(nc, ...)`` boundary buffer would keep all ``nc``
    chunk entries alive; the store refuses it on the caller's thread."""
    from repro_torch.core.storage import (AsyncTransferEngine, HostTree,
                                          RAMStorage)

    params, carry, xs, _ = _segment(13, 3, seed=13)
    out = sf.fused_advance_segment(T_BODY, params, carry, xs, None, chunk=4)
    stacked = out.boundaries
    eng = AsyncTransferEngine(RAMStorage(), device="cpu")
    with pytest.raises(ValueError, match="own their storage"):
        eng.store_async(0, HostTree(tuple(leaf[0] for leaf in stacked)))
    eng.store_async(0, HostTree(out.entries[0]))   # the repaired hand-over
    eng.wait_stores()
    assert eng.backend.live_bytes == sum(
        t.untyped_storage().nbytes() for t in out.entries[0])
    eng.close()



# --- the fused reverse's kernels one by one (csrc/segment_fused.cu) -------


@pytest.mark.parametrize("M,Ka,N,accumulate,slices", [
    (700, 70, 130, 0, 5),   # ragged 64 x 128 output tiles
    (300, 7, 10, 1, 2),     # accumulated onto C
    (300, 300, 20, 0, 2),   # 128-row tiles (8 x 8 a thread), ragged
    (40, 12, 17, 0, 1),
])
def test_grad_reduce_split_m(card_paths, M, Ka, N, accumulate, slices):
    """[A, 1]^T B over M rows, split into slices summed in a fixed order:
    the parameter-gradient reduction of the fused reverse."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(M + Ka)
    A = torch.tensor(_np(rng, (M, Ka)))
    Bm = torch.tensor(_np(rng, (M, N)))
    C0 = torch.tensor(_np(rng, (Ka + 1, N)))
    C = C0.clone()
    S = lib.grad_reduce_slices(Ka, N, M)
    assert S == slices
    part = torch.full((S * (Ka + 1) * N,), float("nan"))
    err = lib.grad_reduce(_ptr(A), Ka, _ptr(Bm), N, M, Ka, N, _ptr(C),
                          accumulate, _ptr(part), None)
    assert err == 0
    want = torch.cat([A, torch.ones(M, 1)], 1).double().t() @ Bm.double()
    if accumulate:
        want = want + C0.double()
    torch.testing.assert_close(C.double(), want, rtol=1e-5, atol=1e-4)
    # two calls give the same bits
    C2 = C0.clone()
    lib.grad_reduce(_ptr(A), Ka, _ptr(Bm), N, M, Ka, N, _ptr(C2),
                    accumulate, _ptr(part), None)
    assert torch.equal(C, C2)


@pytest.mark.parametrize("Bn,L,Dh_,V_", [
    (5, 7, 12, 17),
    (8, 8, 256, 17),   # the logits product split in two slices of Dh
    (40, 8, 12, 17),   # M = 320 rows: 128-row tiles, a ragged one
])
def test_reverse_hoisted_products(card_paths, Bn, L, Dh_, V_):
    """Logits, dlogits and dlogits w_out^T for all rows of a chunk at
    once, against plain PyTorch."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(8)
    M = L * Bn
    w_out = torch.tensor(_np(rng, (Dh_, V_), 0.3))
    b_out = torch.tensor(_np(rng, (V_,), 0.1))
    hs1 = torch.tensor(_np(rng, (M, Dh_)))
    tgt = torch.tensor(rng.integers(0, V_, M), dtype=torch.int32)
    dacc = torch.tensor(0.7)
    dl = torch.empty((M, V_))
    dh_extra = torch.empty((M, Dh_))
    part = torch.full((max(1, lib.lstm_rev_scratch(V_, 8, Dh_, M)),),
                      float("nan"))
    assert lib.lstm_rev_hoisted(_ptr(w_out), _ptr(b_out), V_, Dh_, _ptr(tgt),
                                _ptr(hs1), _ptr(dacc), _ptr(dl),
                                _ptr(dh_extra), M, Bn, _ptr(part), None, 0,
                                None) == 0
    g = 0.7 / Bn
    want = g * (torch.softmax(hs1 @ w_out + b_out, 1)
                - torch.nn.functional.one_hot(tgt.long(), V_))
    torch.testing.assert_close(dl, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dh_extra, want @ w_out.t(), rtol=1e-5,
                               atol=1e-6)


def _cell(z, c):
    i, f, o, g = z.chunk(4, 1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


@pytest.mark.parametrize("Bn,Dh_,L", [(20, 40, 3), (3, 12, 1), (70, 40, 2)])
def test_reverse_walk(card_paths, Bn, Dh_, L):
    """The walk: one launch per step carrying dh_t = dz_t W_h^T, with the
    cell's vjp in its epilogue, against autograd of the cell step by step
    (ragged row and unit tiles at B=20, Dh=40; at B=70 the emulated card's
    4 resident blocks hold 2 column tiles by 2 of the 5 row tiles, so a
    block loops over its row tiles within a step)."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(Bn)
    Dx_ = 8
    N4 = 4 * Dh_
    w = torch.tensor(_np(rng, (Dx_ + Dh_, N4), 0.2))
    z = torch.tensor(_np(rng, (L, Bn, N4)))
    cs = [torch.tensor(_np(rng, (Bn, Dh_), 0.5))]
    acts = []
    for t in range(L):
        i, f, o, g = z[t].chunk(4, 1)
        acts.append(torch.cat([torch.sigmoid(i), torch.sigmoid(f + 1.0),
                               torch.sigmoid(o), torch.tanh(g)], 1))
        cs.append(_cell(z[t], cs[t])[1].detach())
    cs_t, acts_t = torch.stack(cs).contiguous(), torch.stack(acts)
    dh_extra = torch.tensor(_np(rng, (L, Bn, Dh_), 0.1))
    dh0 = torch.tensor(_np(rng, (Bn, Dh_), 0.1))
    dc0 = torch.tensor(_np(rng, (Bn, Dh_), 0.1))
    dh, dc = dh0.clone(), dc0.clone()
    dz = torch.empty((L, Bn, N4))
    bar = torch.zeros(1, dtype=torch.int32)
    assert lib.lstm_rev_walk(_ptr(w), Dx_, Dh_, _ptr(cs_t), _ptr(acts_t),
                             _ptr(dh_extra), _ptr(dh), _ptr(dc), _ptr(dz),
                             L, Bn, _ptr(bar), None) == 0
    rdh, rdc = dh0, dc0
    for t in range(L - 1, -1, -1):
        zt = z[t].clone().requires_grad_(True)
        ct = cs[t].clone().requires_grad_(True)
        dzt, rdc = torch.autograd.grad(_cell(zt, ct), (zt, ct),
                                       (rdh + dh_extra[t], rdc))
        torch.testing.assert_close(dz[t], dzt, rtol=1e-5, atol=1e-6)
        rdh = dzt @ w[Dx_:].t()
    torch.testing.assert_close(dh, rdh, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dc, rdc, rtol=1e-5, atol=1e-6)


def test_fused_reverse_refuses_a_hidden_width_the_walk_cannot_hold(
        card_paths):
    """The walk keeps 32 rows of W_h per block in shared memory: at the
    H100's 227 KB a block, Dh up to 280 fits, and a wider LSTM is refused
    with the limit named before any launch."""
    assert sf._seg_lib().lstm_rev_walk_max_dh() == 280
    Dh_, Bn = 288, 2
    params = {"emb": torch.zeros(V, 4), "w": torch.zeros(4 + Dh_, 4 * Dh_),
              "b": torch.zeros(4 * Dh_), "w_out": torch.zeros(Dh_, V),
              "b_out": torch.zeros(V)}
    carry = (torch.zeros(Bn, Dh_), torch.zeros(Bn, Dh_), torch.zeros(()))
    xs = (torch.zeros((3, Bn), dtype=torch.int32),) * 2
    with pytest.raises(ValueError, match="hidden width 288 is above 280"):
        sf.fused_reverse_segment(T_BODY, (False, False), params, carry, xs,
                                 None, carry, chunk=2)


@pytest.mark.parametrize("M,accumulate", [(600, 1), (100, 0)])
def test_embed_grad_split_m(card_paths, M, accumulate):
    """demb from dx by token id, M split into slices (two at M=600) added
    in order."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(M)
    V_, Dx_ = 11, 8
    tok = torch.tensor(rng.integers(0, V_, M), dtype=torch.int32)
    dx = torch.tensor(_np(rng, (M, Dx_)))
    d0 = torch.tensor(_np(rng, (V_, Dx_)))
    demb = d0.clone()
    part = torch.full((max(1, lib.lstm_rev_scratch(V_, Dx_, 4, M)),),
                      float("nan"))
    assert lib.embed_grad(_ptr(tok), _ptr(dx), M, V_, Dx_, _ptr(demb),
                          accumulate, _ptr(part), None, 0, 1, None) == 0
    want = torch.zeros(V_, Dx_, dtype=torch.float64).index_add_(
        0, tok.long(), dx.double())
    if accumulate:
        want += d0.double()
    torch.testing.assert_close(demb.double(), want, rtol=1e-5, atol=1e-5)
