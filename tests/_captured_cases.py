"""The cases the captured-segment files share
(``test_torch_cuda_emulated_captured*.py``: one file per pair of cases, so
the workers run them side by side): the launch counts, one fused gradient
through the front door captured or not, the Level-2 store options, and the
check that a captured run over a store equals the uncaptured one."""
import numpy as np
import torch
from _cuda_emu import DH, V, _segment

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


def check_captured_equal(monkeypatch, tmp_path, storage):
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


