"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; on the machine
with the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it runs where only PyTorch is installed).
Kernels are held against their plain versions run on the same card with
TF32 off.  Tolerances: the LSTM cell 1e-5 in fp32 and 3e-2 in bf16; fused
advance carries and boundaries 1e-5; fused reverse cotangents 1e-5 and
parameter gradients 1e-4 of each leaf's scale (fp32, different summation
orders).  The front-end cases compare the card with the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.convert import init_lstm_numpy, params_from_numpy
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import segment_fused as sf
from repro_torch.kernels.ref import lstm_cell_ref
from repro_torch.models import lstm

V, DX, DH, B = 17, 8, 12, 3
T_BODY = lstm.train_chain().body


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _segment_operands(T, seed):
    rng = np.random.default_rng(seed)
    params = params_from_numpy(init_lstm_numpy(seed, V, DX, DH),
                               device="cpu")
    carry = (torch.tensor(_np(rng, (B, DH), 0.5)),
             torch.tensor(_np(rng, (B, DH), 0.5)), torch.tensor(1.5))
    xs = (torch.tensor(rng.integers(0, V, (T, B)), dtype=torch.int32),
          torch.tensor(rng.integers(0, V, (T, B)), dtype=torch.int32))
    dcarry = (torch.tensor(_np(rng, (B, DH), 0.1)),
              torch.tensor(_np(rng, (B, DH), 0.1)), torch.tensor(0.7))
    return params, carry, xs, dcarry


def _dev(tree, device):
    if isinstance(tree, dict):
        return {k: v.to(device) for k, v in tree.items()}
    return tuple(t.to(device) for t in tree)


@pytest.mark.cuda
@pytest.mark.parametrize("Bn", [256, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_cell_kernel_matches_plain(cuda_device, Bn, dtype):
    rng = np.random.default_rng(Bn)
    tdt = getattr(torch, dtype)
    Dx, Dh = 64, 256
    arrs = [_np(rng, (Bn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
            _np(rng, (Dx + Dh, 4 * Dh), 0.1), _np(rng, (4 * Dh,), 0.1)]
    args = [torch.tensor(a).to(tdt).to(cuda_device) for a in arrs]
    before = lc.lstm_cell.launches
    hk, ck = lc.lstm_cell(*args)
    torch.cuda.synchronize()
    assert lc.lstm_cell.launches == before + 1
    # the plain version's arithmetic (fp32 math, outputs in the state
    # dtype), on the same card with TF32 off
    hp, cp = (t.to(tdt) for t in lstm_cell_ref(*[a.float() for a in args]))
    tol = 1e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(hk.float(), hp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(ck.float(), cp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk", [(23, 5), (21, 5), (6, 6)])
def test_fused_kernels_match_plain(cuda_device, T, chunk):
    params, carry, xs, dcarry = _segment_operands(T, seed=200 + T)
    p_dev = _dev(params, cuda_device)
    adv0 = sf.fused_advance_segment.launches
    out = sf.fused_advance_segment(T_BODY, p_dev, _dev(carry, cuda_device),
                                   _dev(xs, cuda_device), None, chunk=chunk)
    out.ready.synchronize()
    assert sf.fused_advance_segment.launches == adv0 + 1
    assert all(b.is_pinned() for b in out.boundaries)
    # the plain versions, run on the same card with TF32 off
    plain = sf.advance_plain(T_BODY, p_dev, _dev(carry, cuda_device),
                             _dev(xs, cuda_device), None, chunk=chunk)
    for a, b in zip(out.boundaries, plain.boundaries):
        torch.testing.assert_close(a, b.cpu(), rtol=1e-5, atol=1e-5)
    for a, b in zip(out.carry, plain.carry):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dc, dp, dxd = sf.fused_reverse_segment(
        T_BODY, (False, False), p_dev, _dev(carry, cuda_device),
        _dev(xs, cuda_device), None, _dev(dcarry, cuda_device), chunk=chunk)
    pdc, pdp, _ = sf.reverse_plain(
        T_BODY, (False, False), p_dev, _dev(carry, cuda_device),
        _dev(xs, cuda_device), None, _dev(dcarry, cuda_device), chunk=chunk)
    assert dxd == []
    for a, b in zip(dc, pdc):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for k in pdp:
        scale = float(pdp[k].abs().max())
        torch.testing.assert_close(dp[k], pdp[k], rtol=1e-4,
                                   atol=1e-4 * max(scale, 1e-6))


@pytest.mark.cuda
def test_unregistered_body_raises_on_card(cuda_device):
    def body(p, c, x, batch):
        return c

    with pytest.raises(ValueError, match="bodies"):
        sf.fused_advance_segment(body, {}, (torch.zeros(2, device="cuda"),),
                                 (torch.zeros(4, 2, device="cuda"),), None,
                                 chunk=2)


@pytest.mark.cuda
def test_offloaded_fused_on_card_matches_cpu(cuda_device):
    """The whole front-end on the card: loss, gradients and counters equal
    the CPU run of the same plan (pinned interval)."""
    T = 37
    rng = np.random.default_rng(5)
    ref = init_lstm_numpy(5, V, DX, DH)
    tok = torch.tensor(rng.integers(0, V, (B, T + 1)), dtype=torch.int32)
    out = {}
    for device in ("cpu", "cuda"):
        vg = api.value_and_grad_offloaded(lstm.train_chain(), interval=8,
                                          slots=4, runner="fused",
                                          device=device)
        loss, grads = vg(params_from_numpy(ref, device=device),
                         {"tokens": tok.to(device)})
        out[device] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                       api.last_stats())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for k, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))
    for name in ("advances", "backwards", "l2_stores", "host_dispatches",
                 "fused_segments", "fused_boundary_copies", "l2_peak_bytes"):
        assert getattr(out["cuda"][2], name) == getattr(out["cpu"][2], name)


@pytest.mark.cuda
def test_compiled_runner_on_card_matches_cpu(cuda_device):
    """The plain PyTorch runner on the card: its Level-2 stores go through
    the pinned copy stream and event fence of the engine."""
    T = 29
    rng = np.random.default_rng(6)
    ref = init_lstm_numpy(6, V, DX, DH)
    tok = torch.tensor(rng.integers(0, V, (B, T + 1)), dtype=torch.int32)
    out = {}
    for device in ("cpu", "cuda"):
        vg = api.value_and_grad_offloaded(lstm.train_chain(), interval=6,
                                          slots=3, runner="compiled",
                                          device=device)
        loss, grads = vg(params_from_numpy(ref, device=device),
                         {"tokens": tok.to(device)})
        out[device] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                       api.last_stats())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for k, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))
    assert out["cuda"][2].l2_stores == out["cpu"][2].l2_stores == 5
    assert out["cuda"][2].l2_peak_bytes == out["cpu"][2].l2_peak_bytes
