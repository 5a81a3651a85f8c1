"""The SSD-scan backward's CUDA source (``csrc/ssd_scan_bwd.cu``) run on the
CPU under the emulation of ``tests/_cuda_emu.py`` through its wrapper's
card path, against its plain version (autograd over
``ssd_chunked_plain``): every leaf (dx, ddt, dA, db, dc, dh0) within 1e-4
(fp32) or 3e-2 (bf16) of the plain version's max |value|, with and
without an entry state, groups fewer than heads, a ragged last chunk,
chunks of more than one 64-row tile and a head dim of more than one 64-wide
tile; the same bits on two calls.  A copy of the source that drops the
cotangent carried from one chunk into the chunk before fails the gate
that the unchanged kernel passes.
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
])
def test_ssd_scan_bwd_kernel_source(kernels_on_card, B, T, H, G, P, N,
                                    chunk, dtype, with_h0):
    args = _operands(B, T, H, G, P, N, dtype, with_h0, seed=T + P + H)
    before = ssd.ssd_scan_bwd.launches
    got = ssd.ssd_scan_bwd(*args, chunk=chunk)
    assert ssd.ssd_scan_bwd.launches == before + 1
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


# the reverse state pass of csrc/ssd_scan_bwd.cu, and the same with the
# cotangent carried from chunk 1 into chunk 0 (G_0) dropped
CARRY = "*p = g;"
CARRY_DROPPED = "*p = k == 0 ? 0.0f : g;"


def test_ssd_scan_bwd_check_rejects_a_dropped_carry(
        emulated_libs, kernels_on_card, tmp_path, monkeypatch):
    source = (build.CSRC / build.SOURCES["ssd_scan_bwd"]).read_text()
    assert source.count(CARRY) == 1
    bad = _compile(source.replace(CARRY, CARRY_DROPPED), tmp_path,
                   "ssd_scan_bwd_dropped")
    args = _operands(1, 24, 2, 1, 8, 8, BF16, False, seed=9)
    want = ssd.ssd_scan_bwd_plain(*args, chunk=8)
    _gate(ssd.ssd_scan_bwd(*args, chunk=8), want, 3e-2)
    monkeypatch.setattr(build, "load", lambda name: (
        bad if name == "ssd_scan_bwd" else emulated_libs[name]))
    got = ssd.ssd_scan_bwd(*args, chunk=8)
    assert max(scaled_err(a, b) for a, b in zip(got[:5], want[:5])) > 3e-2


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
