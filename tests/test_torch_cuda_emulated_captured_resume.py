"""Captured fused segments under the emulation of ``tests/_cuda_emu.py``: a
crashed journaled run resumed bit for bit, and the kernels' argument block
(the segment's step offset and its Level-2 slot) against the uncaptured
wrappers on the slice and the plain versions (split off
``test_torch_cuda_emulated_captured.py`` so the workers run them side by
side).
"""
import numpy as np
import pytest
import torch
from _cuda_emu import T_BODY, V, _segment, card_paths, emulated_libs  # noqa: F401

from repro_torch import api
from repro_torch.kernels import segment_fused as sf
from repro_torch.models import lstm


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


