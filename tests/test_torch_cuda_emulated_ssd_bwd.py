"""The SSD-scan backward's CUDA source (``csrc/ssd_scan_bwd.cu``) run on the
CPU under the emulation of ``tests/_cuda_emu.py`` through its wrapper's
card path, against its plain version (autograd over
``ssd_chunked_plain``): every leaf (dx, ddt, dA, db, dc, dh0) within 1e-4
(fp32) or 3e-2 (bf16) of the plain version's max |value|, with and
without an entry state, groups fewer than heads, a ragged last chunk,
chunks of more than one 64-row tile and a head dim of more than one 64-wide
tile (the fp32 passes on the CUDA cores) or of no multiple of 16 with a
state of more than one 64-wide block (bf16: the Hopper form, its wgmma and
swizzled tiles under the stand-ins, no call counted on the CUDA-core
passes); the same bits on two calls.  A copy of the source that drops the
cotangent carried from one chunk into the chunk before fails the gate
that the unchanged kernel passes, in either form.  On bf16-exact inputs
the Hopper form's fp32 leaves (ddt, dA, dh0) are within 2e-4 of the fp32
plain gradient, which a copy without the split operands' low parts
(``LOW_PARTS = 0``: ~2^-9 off) misses.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (_compile, _np, bits_equal, emulated_libs,  # noqa: F401
                       kernels_on_card, scaled_err)

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ssd

F32, BF16 = torch.float32, torch.bfloat16
NAMES = ("dx", "ddt", "dA", "db", "dc", "dh0")


def _operands(B, T, H, G, P, N, dtype, with_h0, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(_np(rng, (B, T, H, P), 0.5)).to(dtype)
    dt = torch.nn.functional.softplus(torch.tensor(_np(rng, (B, T, H))))
    A = -torch.exp(torch.tensor(_np(rng, (H,), 0.3)))
    b = torch.tensor(_np(rng, (B, T, G, N), 0.5)).to(dtype)
    c = torch.tensor(_np(rng, (B, T, G, N), 0.5)).to(dtype)
    h0 = torch.tensor(_np(rng, (B, H, P, N), 0.5)) if with_h0 else None
    dy = torch.tensor(_np(rng, (B, T, H, P))).to(dtype)
    dhf = torch.tensor(_np(rng, (B, H, P, N)))
    return x, dt, A, b, c, h0, dy, dhf


def _gate(got, want, tol):
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        assert scaled_err(a, b) <= tol, (name, scaled_err(a, b))


@pytest.mark.parametrize("B,T,H,G,P,N,chunk,dtype,with_h0", [
    (1, 24, 2, 1, 8, 8, 8, F32, True),        # h0, three chunks
    (2, 20, 4, 2, 16, 8, 8, BF16, False),     # groups < heads, ragged tail
    (2, 20, 4, 2, 16, 8, 8, F32, True),
    (1, 80, 2, 1, 8, 8, 80, F32, False),      # a chunk of two row tiles
    (1, 16, 1, 1, 72, 8, 8, F32, True),       # P over one 64-wide tile
    (1, 24, 2, 1, 8, 8, 8, BF16, True),       # the Hopper form: h0,
    (1, 80, 2, 1, 8, 8, 80, BF16, False),     # two row tiles,
    (1, 16, 1, 1, 24, 72, 8, BF16, True),     # P and N off the tiles
])
def test_ssd_scan_bwd_kernel_source(kernels_on_card, B, T, H, G, P, N,
                                    chunk, dtype, with_h0):
    args = _operands(B, T, H, G, P, N, dtype, with_h0, seed=T + P + H)
    before = ssd.ssd_scan_bwd.launches, ssd.ssd_scan_bwd.cuda_cores
    got = ssd.ssd_scan_bwd(*args, chunk=chunk)
    assert (ssd.ssd_scan_bwd.launches, ssd.ssd_scan_bwd.cuda_cores) == (
        before[0] + 1, before[1])
    want = ssd.ssd_scan_bwd_plain(*args, chunk=chunk)
    _gate(got, want, 3e-2 if dtype == BF16 else 1e-4)
    again = ssd.ssd_scan_bwd(*args, chunk=chunk)
    assert all(a is None and b is None or bits_equal(a, b)
               for a, b in zip(got, again))


def test_ssd_scan_bwd_refuses(kernels_on_card):
    with pytest.raises(ValueError, match="P <= 64"):   # the forward's
        ssd.ssd_scan_bwd(*_operands(1, 8, 1, 1, 72, 4, BF16, False, seed=1),
                         chunk=8)
    args = list(_operands(1, 8, 2, 1, 8, 4, F32, False, seed=1))
    args[6] = args[6][:, :4]
    with pytest.raises(ValueError, match="do not fit"):
        ssd.ssd_scan_bwd(*args, chunk=4)


# the reverse state passes of csrc/ssd_scan_bwd.cu (the Hopper form's and
# the CUDA-core passes'), and the same with the cotangent carried from chunk
# 1 into chunk 0 (G_0) dropped
CARRY = {BF16: ("gk[i] = v[i];   // G_k", "gk[i] = k == 0 ? 0.0f : v[i];"),
         F32: ("*p = g;", "*p = k == 0 ? 0.0f : g;")}


def _rejects_a_dropped_carry(libs, tmp_path, monkeypatch, dtype):
    source = (build.CSRC / build.SOURCES["ssd_scan_bwd"]).read_text()
    carry, dropped = CARRY[dtype]
    assert source.count(carry) == 1
    bad = _compile(source.replace(carry, dropped), tmp_path,
                   "ssd_scan_bwd_dropped")
    args = _operands(1, 24, 2, 1, 8, 8, dtype, False, seed=9)
    want = ssd.ssd_scan_bwd_plain(*args, chunk=8)
    _gate(ssd.ssd_scan_bwd(*args, chunk=8), want, 3e-2)
    monkeypatch.setattr(build, "load", lambda name: (
        bad if name == "ssd_scan_bwd" else libs[name]))
    got = ssd.ssd_scan_bwd(*args, chunk=8)
    assert max(scaled_err(a, b) for a, b in zip(got[:5], want[:5])) > 3e-2


def test_ssd_scan_bwd_check_rejects_a_dropped_carry(
        emulated_libs, kernels_on_card, tmp_path, monkeypatch):
    _rejects_a_dropped_carry(emulated_libs, tmp_path, monkeypatch, BF16)


def test_ssd_scan_bwd_fp32_check_rejects_a_dropped_carry(
        emulated_libs, kernels_on_card, tmp_path, monkeypatch):
    _rejects_a_dropped_carry(emulated_libs, tmp_path, monkeypatch, F32)


# the fp32 leaves' gate against the fp32 plain gradient on bf16-exact
# inputs: the split products keep ~2^-16 of each derived operand, a bf16
# operand alone ~2^-9
LOW_TOL = 2e-4
LOW_PARTS = ("constexpr int LOW_PARTS = 1;", "constexpr int LOW_PARTS = 0;")


def _fp32_leaves_err(args, chunk):
    got = ssd.ssd_scan_bwd(*args, chunk=chunk)
    exact = [None if t is None else t.float() for t in args]
    want = ssd.ssd_scan_bwd_plain(*exact, chunk=chunk)
    return max(scaled_err(got[i], want[i]) for i in (1, 2, 5)
               if want[i] is not None)


@pytest.mark.parametrize("B,T,H,G,P,N,chunk", [
    (1, 24, 2, 1, 8, 8, 8),        # three chunks, h0
    (1, 80, 2, 1, 8, 8, 80),       # two row tiles
])
def test_ssd_scan_bwd_low_parts(emulated_libs, kernels_on_card, tmp_path,
                                monkeypatch, B, T, H, G, P, N, chunk):
    args = _operands(B, T, H, G, P, N, BF16, True, seed=11 + T)
    assert _fp32_leaves_err(args, chunk) <= LOW_TOL
    source = (build.CSRC / build.SOURCES["ssd_scan_bwd"]).read_text()
    assert source.count(LOW_PARTS[0]) == 1
    bad = _compile(source.replace(*LOW_PARTS), tmp_path, "ssd_scan_bwd_hi")
    monkeypatch.setattr(build, "load", lambda name: (
        bad if name == "ssd_scan_bwd" else emulated_libs[name]))
    assert _fp32_leaves_err(args, chunk) > LOW_TOL


def test_ssd_chunked_follows_on_card(kernels_on_card, monkeypatch):
    """``ssd_chunked`` routes through ``build.on_card``: the kernels (both
    directions, counted) where it is true -- here CPU tensors under the
    emulation -- and the plain chunked form (nothing counted) where a
    patch makes it false, as ``chip_smoke._PlainVersions`` does on the
    card."""
    from repro_torch.models import ssm

    def run():
        args = _operands(1, 16, 2, 1, 8, 8, F32, True, seed=4)
        ins = [t.requires_grad_(True) for t in args[:6]]
        y, h = ssm.ssd_chunked(*ins[:5], chunk=8, h0=ins[5])
        (y.sum() + h.sum()).backward()
        return y, [t.grad for t in ins]

    before = (ssd.ssd_scan.launches, ssd.ssd_scan_bwd.launches)
    y, grads = run()
    assert (ssd.ssd_scan.launches, ssd.ssd_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(build, "on_card", lambda t: False)
    y_plain, grads_plain = run()
    assert (ssd.ssd_scan.launches, ssd.ssd_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert scaled_err(y, y_plain) <= 2e-4
    assert all(scaled_err(a, b) <= 1e-4 for a, b in zip(grads, grads_plain))
