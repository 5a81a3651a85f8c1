"""The SSD-scan CUDA source (``csrc/ssd_scan.cu``) run on the CPU under the
emulation of ``tests/_cuda_emu.py``, against its plain version, and a copy
of it that drops one chunk's carried state, which the per-element gates
reject.
"""
import numpy as np
import pytest
import torch
from _cuda_emu import _compile, _np, card_paths, emulated_libs  # noqa: F401

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ssd

def _excess(a, ref, rtol, dims):
    """Per element, |a - ref| beyond rtol |ref|, over the RMS of ref across
    ``dims``; the largest (``chip_smoke.excess``)."""
    a, r = a.float(), ref.float()
    rms = r.pow(2).mean(dims, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((a - r).abs() - rtol * r.abs()).clamp_min(0).div(rms).max())


# the per-element gates of the SSD scan on the card (chip_smoke.TOL): y per
# head over (T, P), the state per head over (P, N)
SSD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-3)}


def _ssd_operands(B, T, H, G, P, N, dtype, with_h0, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(_np(rng, (B, T, H, P), 0.5)).to(dtype)
    dt = torch.nn.functional.softplus(torch.tensor(_np(rng, (B, T, H))))
    A = -torch.exp(torch.tensor(_np(rng, (H,), 0.3)))
    b = torch.tensor(_np(rng, (B, T, G, N), 0.5)).to(dtype)
    c = torch.tensor(_np(rng, (B, T, G, N), 0.5)).to(dtype)
    h0 = torch.tensor(_np(rng, (B, H, P, N), 0.5)) if with_h0 else None
    return x, dt, A, b, c, h0


@pytest.mark.parametrize("B,T,H,G,P,N,chunk,dtype,with_h0", [
    (1, 40, 2, 1, 8, 8, 16, torch.float32, True),    # ragged last chunk
    (2, 32, 4, 2, 16, 12, 8, torch.bfloat16, False),  # groups, bf16
    # several chunks, h0, G < H and a ragged last chunk; the 16-byte copies
    (2, 50, 4, 2, 16, 24, 16, torch.bfloat16, True),
    (2, 50, 4, 2, 16, 24, 16, torch.float32, True),
    # the full tiles of the bf16 kernels (L = 128, P = 64, N = 128)
    (1, 300, 1, 1, 64, 128, 128, torch.bfloat16, True),
])
def test_ssd_scan_kernel_source(card_paths, B, T, H, G, P, N, chunk, dtype,
                                with_h0):
    x, dt, A, b, c, h0 = _ssd_operands(B, T, H, G, P, N, dtype, with_h0,
                                       seed=T + P)
    before = ssd.ssd_scan.launches
    y, h = ssd._launch(x, dt, A, b, c, h0, chunk)
    assert ssd.ssd_scan.launches == before + 1
    y_ref, h_ref = ssd.ssd_scan(x, dt, A, b, c, chunk=chunk, h0=h0)  # plain
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)
    rtol, atol = SSD_TOL[dtype]
    assert _excess(y, y_ref, rtol, (1, 3)) <= atol
    assert _excess(h, h_ref, 2e-4, (2, 3)) <= 2e-4


# the state pass of csrc/ssd_scan.cu, and the same with the state carried
# into chunk 1 dropped (zero, as if the scan restarted there)
SSD_STATE_STORE = "const long k = k0 + u;"
SSD_STATE_DROPPED = ("const long k = k0 + u; if (k == 1) for (int v = 0; "
                     "v < V; ++v) s[v] = 0.0f;")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_check_rejects_a_dropped_chunk_state(card_paths, tmp_path,
                                                      monkeypatch, dtype):
    """A kernel that drops one chunk's S_k fails the per-element gates that
    the unchanged kernel passes (the source mutated here, under the
    emulation)."""
    source = (build.CSRC / build.SOURCES["ssd_scan"]).read_text()
    assert source.count(SSD_STATE_STORE) == 1
    bad = _compile(source.replace(SSD_STATE_STORE, SSD_STATE_DROPPED),
                   tmp_path, "ssd_scan_dropped")
    args = _ssd_operands(2, 50, 4, 2, 16, 24, dtype, False, seed=5)
    chunk = 16
    y_ref, _ = ssd.ssd_scan(*args[:5], chunk=chunk, h0=args[5])
    rtol, atol = SSD_TOL[dtype]
    y, _ = ssd._launch(*args, chunk)
    assert _excess(y, y_ref, rtol, (1, 3)) <= atol
    monkeypatch.setattr(build, "load", lambda name: bad)
    y_bad, _ = ssd._launch(*args, chunk)
    assert _excess(y_bad, y_ref, rtol, (1, 3)) > atol
