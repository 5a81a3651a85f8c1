"""The generic-body fused segments' kernels (``csrc/segment_generic.cu``:
``entry_store`` and ``fold``) compiled with g++ against the CPU stand-in
headers (``tests/_cuda_emu.py``) and run through their wrappers' card paths
on CPU tensors: bit for bit against their plain versions at odd lengths,
misaligned leaves, 0-d leaves, fp32 and bf16; the generic advance, reverse
and a whole ``runner="fused"`` gradient bit for bit against the same on
the plain versions, with one ``entry_store`` launch a forward chunk and one
``fold`` launch a reverse chunk."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from _cuda_emu import _Event, emulated_libs  # noqa: F401  (fixture)
from repro_torch import api
from repro_torch.api.chain import ChainSpec, is_broadcast_zero, zero_grads
from repro_torch.kernels import build
from repro_torch.kernels import segment_fused as sf
from repro_torch.kernels import segment_generic as sg


class _Stream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


class _TorchOnHost:
    """``torch`` as segment_generic sees it under the emulation: the
    stream context and events are stubs."""

    cuda = types.SimpleNamespace(Event=_Event,
                                 stream=lambda s: contextlib.nullcontext())

    def __getattr__(self, name):
        return getattr(torch, name)


@contextlib.contextmanager
def _on_card(libs):
    """The wrappers' card paths on CPU tensors, with the emulated kernels."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "load", lambda name: libs[name])
        mp.setattr(build, "stream_ptr", lambda device=None: ctypes.c_void_p(0))
        mp.setattr(sg, "_on_cpu", lambda tensors: False)
        mp.setattr(sg, "_streams", lambda dev: (_Stream(), _Stream()))
        mp.setattr(sg, "_hold", lambda tensors, stream: None)
        mp.setattr(sg, "torch", _TorchOnHost())
        mp.setattr(sf, "_ADDRESS", {})
        yield


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


def _rand(rng, shape, dtype=torch.float32):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(
        dtype)


def _store_leaves(rng):
    """Leaves of every kind entry_store meets: a 0-d fp32 accumulator, a
    bf16 leaf of odd length, fp32 of a length that leaves a tail after the
    16-byte stores, a 2-D bf16 state, and a misaligned view (4 bytes into
    its buffer)."""
    buf = _rand(rng, (41,))
    return [_rand(rng, ()), _rand(rng, (1001,), torch.bfloat16),
            _rand(rng, (37,)), _rand(rng, (3, 5, 8), torch.bfloat16),
            buf[1:40]]


def test_entry_store_bit_for_bit(emulated_libs):
    srcs = _store_leaves(np.random.default_rng(0))
    plain = [torch.empty_like(s) for s in srcs]
    sg.entry_store_plain(srcs, plain)
    dsts = [torch.full_like(s, 7.0) for s in srcs]
    n0 = sg.entry_store.launches
    with _on_card(emulated_libs):
        ready = sg.entry_store(srcs, dsts)
    assert ready is not None and sg.entry_store.launches == n0 + 1
    assert all(_same_bits(d, p) for d, p in zip(dsts, plain))
    assert srcs[-1].data_ptr() % 16 == 4   # the byte path ran


def _fold_case(rng):
    """An accumulator of fp32 and bf16 leaves (one still a broadcast zero,
    one 0-d), cotangents of both types (one a broadcast zero: not read)
    and a second, a tail chunk's (added after the first), and rows of a
    full-chain buffer, one of them misaligned."""
    gacc = {"w": _rand(rng, (7, 9)), "b": _rand(rng, (13,), torch.bfloat16),
            "s": _rand(rng, ()), "fresh": torch.zeros(()).expand(5, 3),
            "unread": _rand(rng, (4,)), "mixed": _rand(rng, (11,)),
            "bb": _rand(rng, (9,), torch.bfloat16)}
    dp = {"w": _rand(rng, (7, 9)), "b": _rand(rng, (13,)),
          "s": _rand(rng, ()), "fresh": _rand(rng, (5, 3)),
          "unread": torch.zeros(()).expand(4),
          "mixed": _rand(rng, (11,), torch.bfloat16),
          "bb": _rand(rng, (9,), torch.bfloat16)}
    # the tail reads every parameter but "w" and "unread"
    tail = {k: (torch.zeros(()).expand(v.shape) if k in ("w", "unread")
                else _rand(rng, v.shape, v.dtype)) for k, v in dp.items()}
    full = [_rand(rng, (6, 3)), _rand(rng, (6, 5), torch.bfloat16)]
    rows = [full[0][1:4], full[1][2:5]]
    src = [_rand(rng, (3, 3)), _rand(rng, (3, 5), torch.bfloat16)]
    return gacc, [dp, tail], full, rows, src


def _clone_case(case):
    gacc, dp, full, rows, src = case
    full2 = [f.clone() for f in full]
    return ({k: v if is_broadcast_zero(v) else v.clone()
             for k, v in gacc.items()}, dp, full2,
            [full2[0][1:4], full2[1][2:5]], src)


def test_fold_bit_for_bit(emulated_libs):
    case = _fold_case(np.random.default_rng(1))
    ref = _clone_case(case)
    acc, ops = sg.fold_plan(ref[0], ref[1], ref[3], ref[4])
    assert sorted(len(srcs) for _, srcs, _ in ops) == [1] * 3 + [2] * 5
    sg.fold_plain(ops)
    want = dict(zip(ref[0], acc))
    gacc, dps, full, rows, src = case
    unread = gacc["unread"].clone()
    n0 = sg.fold.launches
    with _on_card(emulated_libs):
        got = sg.fold(gacc, dps, rows, src)
    assert sg.fold.launches == n0 + 1
    assert rows[0].data_ptr() % 16 == 12   # a misaligned copy
    for k in want:
        assert _same_bits(got[k], want[k]), k
    assert got["w"] is gacc["w"]          # added in place
    assert not is_broadcast_zero(got["fresh"])
    assert torch.equal(got["unread"], unread)   # a broadcast zero: skipped
    for a, b in zip(full, ref[2]):
        assert _same_bits(a, b)


# ----------------------------------------------------------- the segments

B, D = 3, 8


def _ssm_spec():
    """The diagonal SSM chain of ``tests/test_kernels.py:220`` (float xs:
    the reverse writes input cotangents)."""
    def prelude(p, batch):
        return (torch.zeros(B, D), torch.tensor(0.0)), batch["xs"]

    def body(p, carry, x, batch):
        h, acc = carry
        h = torch.exp(-torch.nn.functional.softplus(p["logA"])) * h \
            + x @ p["Bm"]
        return h, acc + torch.mean((h @ p["Cm"]) ** 2)

    return ChainSpec(prelude, body, lambda p, c, b: c[1], name="ssm-emu")


def _ssm_inputs(T, seed):
    rng = np.random.default_rng(seed)
    params = {"logA": _rand(rng, (D,)) * 0.1, "Bm": _rand(rng, (D, D)) * 0.3,
              "Cm": _rand(rng, (D, D)) * 0.3}
    return params, {"xs": _rand(rng, (T, B, D)) * 0.4}


def _segment(T, chunk):
    spec = _ssm_spec()
    params, batch = _ssm_inputs(T, seed=T)
    carry = (_rand(np.random.default_rng(5), (B, D)), torch.tensor(0.5))
    dcarry = (_rand(np.random.default_rng(6), (B, D)), torch.tensor(1.0))
    adv = sg.advance(spec.body, params, carry, batch["xs"], None,
                     chunk=chunk)
    # entries past the first are the pools' scratch pair, which the next
    # advance writes again: read them now
    adv = adv._replace(entries=[tuple(t.clone() for t in e)
                                for e in adv.entries])
    gacc = zero_grads(params)
    rows = [torch.zeros(T, B, D)]
    dc, gacc = sg.reverse(spec.body, (True,), params, carry, batch["xs"],
                          None, dcarry, gacc, rows, chunk=chunk)
    return adv, dc, gacc, rows


@pytest.mark.parametrize("T,chunk", [(11, 4), (9, 4), (6, 6)])
def test_generic_segments_bit_for_bit(emulated_libs, T, chunk):
    """T=11: forward chunks 4, 4, 3, reverse 4, 4, 3 (a short tail folded
    last); T=9: forward 4, 5 (a length-1 tail merged), reverse 4, 4, 1;
    T=6: one chunk."""
    plain = _segment(T, chunk)
    e0, f0 = sg.entry_store.launches, sg.fold.launches
    with _on_card(emulated_libs):
        card = _segment(T, chunk)
    nf = len(sf.forward_bounds(T, chunk)) - 1
    nr = sf.reverse_layout(T, chunk)[1]
    assert sg.entry_store.launches - e0 == nf
    assert sg.fold.launches - f0 == nr
    adv, adv_p = card[0], plain[0]
    assert len(adv.entries) == len(adv_p.entries) == nf
    for a, b in zip(adv.carry, adv_p.carry):
        assert _same_bits(a, b)
    # the segment entry, and the chunk entries the two scratch slots still
    # hold (the last two)
    for k in [0] + list(range(max(1, nf - 2), nf)):
        assert all(_same_bits(a, b)
                   for a, b in zip(adv.entries[k], adv_p.entries[k])), k
    for a, b in zip(card[1], plain[1]):
        assert _same_bits(a, b)
    for k in plain[2]:
        assert _same_bits(card[2][k], plain[2][k]), k
    assert _same_bits(card[3][0], plain[3][0])


def test_generic_runner_bit_for_bit(emulated_libs):
    """A whole ``runner="fused"`` gradient (uneven segments and chunks)
    through the emulated kernels, bit for bit the plain versions' run."""
    spec = _ssm_spec()
    params, batch = _ssm_inputs(23, seed=3)

    def run():
        vg = api.value_and_grad_offloaded(spec, interval=8, slots=3,
                                          runner="fused", device="cpu")
        return vg(params, batch), api.last_stats()

    (loss_p, grads_p), stats_p = run()
    e0, f0 = sg.entry_store.launches, sg.fold.launches
    with _on_card(emulated_libs):
        (loss, grads), stats = run()
    assert _same_bits(loss, loss_p)
    for k in grads_p:
        assert _same_bits(grads[k], grads_p[k]), k
    # segments 8, 8, 7 at chunks 3, 3, 3: forward 3 + 3 + 2 chunks
    # (7 = 3 + 4), reverse 3 + 3 + 3
    assert sg.entry_store.launches - e0 == 8
    assert sg.fold.launches - f0 == 9
    assert stats.fused_boundary_copies == stats_p.fused_boundary_copies \
        == 8 + 2 * 9
