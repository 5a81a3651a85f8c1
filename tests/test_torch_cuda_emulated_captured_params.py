"""Captured fused segments under the emulation of ``tests/_cuda_emu.py``:
a captured run takes new and rewritten parameters, and
``segment_fused.clear_caches`` makes the next run capture anew (split off
``test_torch_cuda_emulated_captured.py`` so the workers run them side by
side).
"""
import numpy as np
import torch
from _captured_cases import _fused_gradient
from _cuda_emu import V, _segment, card_paths, emulated_libs  # noqa: F401

from repro_torch.kernels import segment_fused as sf


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
