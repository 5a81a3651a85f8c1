"""Captured fused segments (``segment_fused.CapturedRun``) run on the CPU
under the emulation of ``tests/_cuda_emu.py``, where each graph replay runs
its launches again: through the front door bit for bit the uncaptured
segments over each Level-2 store, with the same counters and launches, a
second call reusing the graphs and the pooled page-locked slots; a crashed
journaled run resumed bit for bit; and the kernels' argument block (the
segment's step offset and its Level-2 slot) against the uncaptured
wrappers on the slice and the plain versions.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (DH, T_BODY, V, _segment, card_paths,  # noqa: F401
                       emulated_libs)

from repro_torch import api
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import segment_fused as sf
from repro_torch.models import lstm

COUNTERS = ("advances", "backwards", "l2_stores", "host_dispatches",
            "fused_segments", "fused_boundary_copies", "l2_peak_bytes",
            "l2_fast_peak_bytes", "l2_evictions", "l2_promotions")


def _launch_counts():
    adv, rev = sf.fused_advance_segment, sf.fused_reverse_segment
    return (lc.lstm_cell.launches, lc.lstm_cell.steps, adv.launches,
            adv.cell_launches, adv.cell_steps, rev.launches,
            rev.cell_launches, rev.cell_steps)


def _fused_gradient(monkeypatch, captured, params, tok, **kw):
    """One fused gradient through the front door, captured or not: (loss,
    grads, stats, launch counts made)."""
    monkeypatch.setattr(sf, "_CAPTURED", captured)
    before = _launch_counts()
    loss, grads = api.value_and_grad_offloaded(
        lstm.train_chain(), runner="fused", device="cpu", **kw)(
        params, {"tokens": tok})
    made = tuple(a - b for a, b in zip(_launch_counts(), before))
    return loss, grads, api.last_stats(), made


def _storage_kw(storage, tmp_path):
    state = 2 * 3 * DH * 4 + 4   # one (h, c, acc) boundary at B=3
    return {"ram": {},
            "tiered": {"storage": "tiered", "l2_capacity_bytes": state,
                       "storage_dir": str(tmp_path / "slow")},
            "compressed": {"storage": "compressed"},
            "journaled": {"journal_dir": str(tmp_path / "wal")}}[storage]


@pytest.mark.parametrize("storage", ["ram", "tiered", "compressed",
                                     "journaled"])
def test_captured_segments_equal_the_uncaptured_ones(card_paths, monkeypatch,
                                                     tmp_path, storage):
    """The front door's fused gradient with captured segments (graphs
    replayed, an argument block per replay, pooled Level-2 slots, the
    gradient added into one flat accumulator) is bit for bit the
    uncaptured run's, with the same counters and launch counts, over each
    Level-2 store (a tiered fast tier of one state); a 15-step chain at
    I=6 has a 3-step tail segment (a second graph shape), and every
    segment but the first starts at a non-zero step.  The slot pool grows
    to the most slots the run holds at once: the three boundaries over
    RAM; over the tiered and the compressed store at most the states kept
    in RAM (the fast tier's one, none), the prefetch depth and two more.  Over RAM, a second captured call
    captures nothing new and takes no new slot."""
    for cache in ("_GRAPHS", "_POOLS", "_RINGS"):   # this test's own
        monkeypatch.setattr(sf, cache, {})
    params, _, _, _ = _segment(1, 1, seed=31)
    tok = torch.tensor(np.random.default_rng(3).integers(0, V, (3, 16)),
                       dtype=torch.int32)
    kw = dict(interval=6, slots=3, **_storage_kw(storage, tmp_path))
    ref = _fused_gradient(monkeypatch, False, params, tok, **kw)
    captures = sf.CapturedRun.captures
    runs = [_fused_gradient(monkeypatch, True, params, tok, **kw)]
    # segments of 6, 6 and 3 steps: the advance's carry ping-pongs in the
    # 6-step graphs (both carries captured), enters the 3-step one from
    # outside; the reverse's cotangent enters the 3-step graph and the
    # first 6-step one from outside, then ping-pongs: 6 graphs
    assert sf.CapturedRun.captures == captures + 6
    pool = next(iter(sf._POOLS.values()))
    assert pool.size == max(2, pool.peak)   # grown on demand
    if storage == "ram":
        assert pool.peak == 3
    if storage in ("tiered", "compressed"):
        kept = 1 if storage == "tiered" else 0   # states kept in RAM
        assert pool.peak <= kept + runs[0][2].prefetch_depth + 2
    if storage == "ram":
        grown = pool.grown
        runs.append(_fused_gradient(monkeypatch, True, params, tok, **kw))
        assert sf.CapturedRun.captures == captures + 6
        assert pool.grown == grown
    assert pool.free == pool.size   # every slot back once Level 2 let go
    for run in runs:
        assert torch.equal(run[0], ref[0])
        assert all(torch.equal(run[1][k], ref[1][k]) for k in ref[1])
        for name in COUNTERS:
            assert getattr(run[2], name) == getattr(ref[2], name), name
        assert run[3] == ref[3]


def test_captured_run_resumes_a_crash_bit_for_bit(card_paths, monkeypatch,
                                                  tmp_path):
    """A journaled captured gradient killed at its second forward store
    resumes (``resume_offloaded``) to the fault-free captured run's loss
    and gradients, bit for bit."""
    from repro_torch.core import faults
    from repro_torch.core.faults import FaultPlan

    params, _, _, _ = _segment(1, 1, seed=32)
    tok = torch.tensor(np.random.default_rng(4).integers(0, V, (3, 16)),
                       dtype=torch.int32)
    kw = {"interval": 5, "slots": 3, "runner": "fused", "device": "cpu"}
    spec = lstm.train_chain()
    loss, grads = api.value_and_grad_offloaded(
        spec, journal_dir=str(tmp_path / "free"), **kw)(params,
                                                        {"tokens": tok})
    jd = str(tmp_path / "wal")
    with pytest.raises(Exception) as ei:
        with faults.inject(FaultPlan(kill_writer_at_store=2)):
            api.value_and_grad_offloaded(spec, journal_dir=jd, **kw)(
                params, {"tokens": tok})
    assert faults.is_storage_fault(ei.value)
    r_loss, r_grads = api.resume_offloaded(spec, params, {"tokens": tok},
                                           journal_dir=jd, **kw)
    assert torch.equal(r_loss, loss)
    assert all(torch.equal(r_grads[k], grads[k]) for k in grads)
    assert 0 < api.last_stats().replayed_advances <= 5


def test_argument_block_reads_a_segment_at_its_offset(card_paths):
    """The kernels' device-resident argument block: a captured advance and
    reverse of steps [7, 16) of a 20-step chain (the step loop, the
    readout and loss, the accumulator chain, the hoisted products and the
    embedding gradient reading their ids at offset 7; the boundary
    written into a pooled Level-2 slot) equal the uncaptured wrappers on
    the slice bit for bit, and the plain versions within 1e-5."""
    params, carry, (tok, tgt), dcarry = _segment(20, 5, seed=33)
    lo, T, chunk = 7, 9, 4
    xs_seg = (tok[lo:lo + T], tgt[lo:lo + T])
    run = sf.CapturedRun(T_BODY, params, (tok, tgt))
    got = run.advance(carry, lo, T, chunk, last=True)
    want = sf.fused_advance_segment(T_BODY, params, carry, xs_seg, None,
                                    chunk=chunk)
    plain = sf.advance_plain(T_BODY, params, carry, xs_seg, None,
                             chunk=chunk)
    for a, b, c in zip(list(got.carry) + list(got.entries[0]),
                       list(want.carry) + list(want.entries[0]),
                       list(plain.carry) + list(plain.entries[0])):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
    dc, gflat = run.reverse(carry, dcarry, lo, T, chunk, last=True)
    wdc, wdp, _ = sf.fused_reverse_segment(T_BODY, (False, False), params,
                                           carry, xs_seg, None, dcarry,
                                           chunk=chunk)
    _, pdp, _ = sf.reverse_plain(T_BODY, (False, False), params, carry,
                                 xs_seg, None, dcarry, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(dc, wdc))
    views = sf._grad_views(gflat, run.dims)
    for k in pdp:
        assert torch.equal(views[k], wdp[k]), k
        torch.testing.assert_close(
            views[k], pdp[k], rtol=1e-4,
            atol=1e-4 * max(float(pdp[k].abs().max()), 1e-6))


def test_captured_run_takes_new_and_rewritten_parameters(card_paths,
                                                         monkeypatch):
    """The graphs read a static copy of the parameters that each captured
    run writes as it starts, whether the caller's are other tensors (which
    may reuse a freed one's address) or were written in place since: each
    captured gradient equals the uncaptured one for the parameters of its
    own call."""
    tok = torch.tensor(np.random.default_rng(5).integers(0, V, (3, 12)),
                       dtype=torch.int32)
    kw = {"interval": 6, "slots": 3}
    for seed in (34, 35):   # new tensors of the same shapes
        params, _, _, _ = _segment(1, 1, seed=seed)
        for _ in range(2):
            want = _fused_gradient(monkeypatch, False, params, tok, **kw)
            got = _fused_gradient(monkeypatch, True, params, tok, **kw)
            assert torch.equal(got[0], want[0])
            assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
            params["w"].mul_(1.25)   # written in place
        del params


def test_clear_caches_drops_the_graphs_and_a_run_captures_anew(card_paths,
                                                              monkeypatch):
    """``segment_fused.clear_caches`` drops the graphs, their workspaces,
    the parameters' static copies and the slot pools; the next captured
    gradient captures its graphs again and is still bit for bit the
    uncaptured one."""
    for cache in ("_GRAPHS", "_PARAMS", "_POOLS", "_RINGS", "_ADDRESS"):
        monkeypatch.setattr(sf, cache, {})
    params, _, _, _ = _segment(1, 1, seed=36)
    tok = torch.tensor(np.random.default_rng(6).integers(0, V, (3, 12)),
                       dtype=torch.int32)
    kw = {"interval": 6, "slots": 3}
    want = _fused_gradient(monkeypatch, False, params, tok, **kw)
    runs = [_fused_gradient(monkeypatch, True, params, tok, **kw)]
    assert sf._GRAPHS and sf._PARAMS and sf._POOLS
    sf.clear_caches()
    assert not (sf._GRAPHS or sf._PARAMS or sf._POOLS or sf._RINGS)
    captures = sf.CapturedRun.captures
    runs.append(_fused_gradient(monkeypatch, True, params, tok, **kw))
    assert sf.CapturedRun.captures > captures
    for got in runs:
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
        assert got[3] == want[3]
