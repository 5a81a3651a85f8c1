"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; on the machine
with the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it runs where only PyTorch is installed).
Kernels are held against their plain versions run on the same card with
TF32 off.  Tolerances: the LSTM cell 1e-5 in fp32 and 3e-2 in bf16; fused
advance carries and boundaries 1e-5; fused reverse cotangents 1e-5 and
parameter gradients 1e-4 of each leaf's scale (fp32, different summation
orders).  The front-end cases compare the card with the CPU.  Flash
attention and the SSD scan are held per element (:func:`_assert_close_to`:
rtol times |ref| plus atol times an RMS of ref: attention's per row, the
SSD scan's per head), at (2e-4, 2e-4) in fp32; in bf16 the SSD scan's y at
(1e-2, 1e-3) and attention at (1e-2, 2e-2), since it also rounds p at
another point of the softmax; the SSD state at (2e-4, 2e-4) and the
attention logsumexp at 1e-5 of the plain chunked forward's.  The
redesigned kernels (bf16 flash attention and the SSD scan on the tensor
cores, the fused reverse, the LSTM cell's step loop) give the same bits on
two calls; a cooperative grid that cannot be resident is refused; the
fused advance's states are, bit for bit, those of one run of the step
loop over the segment, and each of its chunk entries is a page-locked
allocation of its own.  The cell kernel under autograd (the per-step
strategies' path) matches plain autograd through ``lstm_cell_ref`` at
1e-5, and the Revolve, store-all and interpreted strategies on the card
match the CPU run, as does the fused runner over the disk and tiered
Level-2 backends (counters equal).  A journaled fused gradient on the card
is bit-identical to the unjournaled one and, after a writer kill at every
forward store or a failed fetch at every reverse fetch, its resume is
bit-identical to both (deterministic algorithms on), with the resume's
counters equal to the CPU run's.  The
decoder chains on the card (dense, SSM, MoE and hybrid): the offloaded
gradient against dense autograd on the card, loss 1e-5 relative and each
leaf 1e-4 of its max |g|, each kernel launched once a layer that runs it
for every chain step advanced.  The scan engine (``engine="scan"``) on
the card matches the CPU with its boundaries in page-locked memory and a
device peak flat in the chain's length, and a streamed MoE call
(``offload_params="moe_experts"``, experts on the host) is bit for bit the
unstreamed one.  A budget-driven 2D plan splits jamba's period on the card
(the offloaded gates, inner counters equal to the perfmodel's), and the
byte profile of a full-width chain allocates no device memory.
``runner="fused"`` on a generic chain body (the two reference chains of
``tests/test_kernels.py``, jamba at SMOKE width) against
``runner="compiled"`` on the card: the loss bit for bit, each leaf within
1e-4 of its max |g|, the plan equal, ``entry_store`` launched once a
forward chunk and ``fold`` once a reverse chunk.  The attention backward
kernel against its plain version (fp32 2e-4, bf16 3e-2 of the plain max
|value|, two calls bit for bit), and the layer functions (rmsnorm with the
residual, GeGLU, SwiGLU, rope of q and k) on the card against the same on
the CPU, values and gradients (fp32 1e-5, bf16 3e-2), each kernel launched
once each way.  The projection GEMM (``kernels/dense.py``) against its
plain version at a smoke shape and at gemma2-2b's gate projection, per
element (bf16: 1e-2 of |ref| plus 1e-3 of the row's RMS), two calls bit for
bit, and ``dense_fwd``, ``dense_bwd`` counted in the MoE and hybrid
decoders' gradients, as are the MoE layers' kernels (the routing, the
slots, the dispatch, the combine, the experts' products, each backward);
phi3.5-moe at SMOKE width through ``runner="fused"`` against
``runner="compiled"``, its MoE kernels launched as the fused plan implies.
"""
import gc
import os

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.convert import init_lstm_numpy, params_from_numpy
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.configs.shapes import make_batch
from repro_torch.kernels import dense as dn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import moe as mk
from repro_torch.kernels import segment_fused as sf
from repro_torch.kernels import segment_generic as sg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import lstm_cell_ref
from repro_torch.models import lstm
from repro_torch.models.attention import _chunked_fwd, chunked_attention
from repro_torch.models.model_factory import get_model

# cuBLAS reads this once, when the process makes its first handle: set here,
# at import (before any test's card work), it holds for the resume test's
# GEMMs under deterministic algorithms.  It restricts only cuBLAS's
# workspace, so it is left set for the session.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


def _assert_close_to(a, ref, rtol, atol, dims=(-1,)):
    """|a - ref| <= rtol |ref| + atol RMS(ref over dims), per element."""
    a, r = a.float(), ref.float()
    rms = r.pow(2).mean(dims, keepdim=True).sqrt()
    bad = (a - r).abs() > rtol * r.abs() + atol * rms
    assert not bool(bad.any()), \
        f"{int(bad.sum())} elements off; max abs err {(a - r).abs().max()}"


TOL = {"flash_attention": {"float32": (2e-4, 2e-4),
                                "bfloat16": (1e-2, 2e-2)},
           "ssd_scan": {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-3)}}


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
@pytest.mark.parametrize("T,chunk", [(23, 5), (21, 5), (6, 6), (1, 4),
                                     (4, 9), (9, 4)])
def test_fused_kernels_match_plain(cuda_device, T, chunk):
    params, carry, xs, dcarry = _segment_operands(T, seed=200 + T)
    p_dev = _dev(params, cuda_device)
    adv0 = sf.fused_advance_segment.launches
    out = sf.fused_advance_segment(T_BODY, p_dev, _dev(carry, cuda_device),
                                   _dev(xs, cuda_device), None, chunk=chunk)
    out.ready.synchronize()
    assert sf.fused_advance_segment.launches == adv0 + 1
    # each chunk entry is page-locked and owns its storage (Level 2 keeps
    # entries[0] by reference and counts its tree_bytes)
    for entry in out.entries:
        assert all(t.is_pinned() for t in entry)
        assert sum(t.untyped_storage().nbytes() for t in entry) == sum(
            t.numel() * t.element_size() for t in entry)
    # the plain versions, run on the same card with TF32 off
    # (the plain chain step: on the card T_BODY launches the cell kernel)
    plain = sf.advance_plain(lstm.plain_body, p_dev,
                             _dev(carry, cuda_device), _dev(xs, cuda_device),
                             None, chunk=chunk)
    for a, b in zip(out.boundaries, plain.boundaries):
        torch.testing.assert_close(a, b.cpu(), rtol=1e-5, atol=1e-5)
    for a, b in zip(out.carry, plain.carry):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dc, dp, dxd = sf.fused_reverse_segment(
        T_BODY, (False, False), p_dev, _dev(carry, cuda_device),
        _dev(xs, cuda_device), None, _dev(dcarry, cuda_device), chunk=chunk)
    pdc, pdp, _ = sf.reverse_plain(
        lstm.plain_body, (False, False), p_dev, _dev(carry, cuda_device),
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
    """An unregistered body runs the generic path on the card: its
    segments launch ``entry_store`` once a forward chunk and ``fold`` once
    a reverse chunk (never the plain versions), and a carry with a CPU
    leaf beside CUDA leaves raises ``ValueError``."""
    def body(p, c, x, batch):
        return (c[0] * p["a"] + x, c[1] + c[0].sum())

    params = {"a": torch.tensor(0.9, device="cuda")}
    carry = (torch.ones(2, device="cuda"), torch.zeros((), device="cuda"))
    xs = torch.linspace(0, 1, 8, device="cuda").reshape(4, 2)
    e0, f0 = sg.entry_store.launches, sg.fold.launches
    out = sf.fused_advance_segment(body, params, carry, xs, None, chunk=2)
    out.ready.synchronize()
    assert sg.entry_store.launches - e0 == len(out.entries) == 2
    assert all(t.is_pinned() for e in out.entries for t in e)
    dc, dp, dxd = sf.fused_reverse_segment(
        body, (True,), params, carry, xs, None,
        (torch.zeros(2, device="cuda"), torch.ones((), device="cuda")),
        chunk=2)
    assert sg.fold.launches - f0 == 2
    assert dxd[0].shape == xs.shape and dp["a"].is_cuda
    with pytest.raises(ValueError, match="one device"):
        sf.fused_advance_segment(body, params, (carry[0], torch.zeros(())),
                                 xs, None, chunk=2)


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
def test_lstm_cell_under_autograd_on_card(cuda_device):
    """The cell kernel inside its autograd Function at the paper's width:
    one launch forward, none backward (the plain cell's vjp, recomputed),
    gradients of every input within 1e-5 of plain autograd through
    ``lstm_cell_ref`` on the card."""
    rng = np.random.default_rng(31)
    Bn, Dx, Dh = 256, 64, 256
    ins = [torch.tensor(a, device=cuda_device) for a in (
        _np(rng, (Bn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), (Dx + Dh) ** -0.5),
        _np(rng, (4 * Dh,), 0.1))]
    gh, gc = (torch.tensor(_np(rng, (Bn, Dh)), device=cuda_device)
              for _ in range(2))

    def grads(cell):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        h, c = cell(*leaves)
        return [h, c], list(torch.autograd.grad(
            (h * gh).sum() + (c * gc).sum(), leaves))

    before = lc.lstm_cell.launches
    out, g = grads(lc.lstm_cell_autograd)
    torch.cuda.synchronize()
    assert lc.lstm_cell.launches == before + 1
    ref_out, ref_g = grads(lstm_cell_ref)
    for a, b in zip(out + g, ref_out + ref_g):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,forward_steps", [
    ({"strategy": "conventional"}, 29),
    ({"strategy": "revolve", "slots": 4}, 29),
    ({"engine": "interpreted", "interval": 7, "slots": 3}, 0),
])
def test_strategies_on_card_match_cpu(cuda_device, kw, forward_steps):
    """The paper's baselines and the interpreted engine on the card: loss,
    gradients and counters equal the CPU run, and the cell kernel runs once
    a chain step (the baselines' forward sweep, each advance, each
    backward's recompute)."""
    T = 29
    rng = np.random.default_rng(8)
    ref = init_lstm_numpy(8, V, DX, DH)
    tok = torch.tensor(rng.integers(0, V, (B, T + 1)), dtype=torch.int32)
    out = {}
    for device in ("cpu", "cuda"):
        vg = api.value_and_grad_offloaded(lstm.train_chain(), device=device,
                                          **kw)
        before = lc.lstm_cell.launches
        loss, grads = vg(params_from_numpy(ref, device=device),
                         {"tokens": tok.to(device)})
        out[device] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                       api.last_stats(), lc.lstm_cell.launches - before)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for k, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))
    stats = out["cuda"][2]
    for name in ("advances", "backwards", "host_dispatches",
                 "peak_l1_states", "l2_stores", "l2_peak_bytes"):
        assert getattr(stats, name) == getattr(out["cpu"][2], name), name
    assert out["cpu"][3] == 0
    assert out["cuda"][3] == forward_steps + stats.advances + stats.backwards


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"storage": "tiered", "budget": 1},
    {"storage": "tiered", "budget": 2},
    {"storage": "disk"},
])
def test_fused_runner_level2_backends_on_card_match_cpu(cuda_device, kw,
                                                         tmp_path):
    """The fused runner's page-locked chunk entries through the other
    Level-2 backends on the card: a tiered fast tier keeps them by
    reference, spills pickle them to disk, promotions come back pageable
    and are staged through page-locked memory for the upload.  Loss,
    gradients and the Level-2 counters equal the CPU run's."""
    T = 29
    rng = np.random.default_rng(9)
    ref = init_lstm_numpy(9, V, DX, DH)
    tok = torch.tensor(rng.integers(0, V, (B, T + 1)), dtype=torch.int32)
    store = {"storage": kw["storage"], "storage_dir": str(tmp_path)}
    if "budget" in kw:
        store["l2_capacity_bytes"] = kw["budget"] * (2 * B * DH * 4 + 4)
    out = {}
    for device in ("cpu", "cuda"):
        vg = api.value_and_grad_offloaded(lstm.train_chain(), interval=6,
                                          slots=3, runner="fused",
                                          device=device, **store)
        loss, grads = vg(params_from_numpy(ref, device=device),
                         {"tokens": tok.to(device)})
        out[device] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                       api.last_stats())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for k, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))
    for name in ("l2_stores", "l2_fast_peak_bytes", "l2_evictions",
                 "l2_promotions", "prefetch_depth", "fused_segments"):
        assert getattr(out["cuda"][2], name) == \
            getattr(out["cpu"][2], name), name
    if "budget" in kw:
        assert out["cuda"][2].l2_evictions == 5 - kw["budget"]
    assert os.listdir(tmp_path) == []


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


@pytest.mark.cuda
@pytest.mark.parametrize("dims,dtype,kw", [
    # gemma2-2b's layer at the dense phase's shape (the tensor-core kernel)
    ((2, 4096, 4096, 8, 4, 256), "bfloat16", {"softcap": 50.0,
                                              "scale": 0.0625}),
    ((2, 512, 512, 8, 4, 256), "bfloat16", {"softcap": 50.0,
                                            "scale": 0.0625}),
    ((1, 700, 900, 4, 2, 128), "bfloat16", {"window": 256}),   # Sq < Sk
    ((1, 300, 300, 4, 4, 256), "float32", {"window": 64}),
    ((2, 200, 333, 4, 2, 64), "float32", {"softcap": 20.0}),   # Sq < Sk
    ((1, 129, 129, 2, 1, 64), "bfloat16", {"causal": False}),
    # gemma2-2b SMOKE's head dim 16 (window, softcap), and 32
    ((2, 300, 300, 4, 2, 16), "bfloat16", {"window": 8, "softcap": 50.0,
                                           "scale": 0.25}),
    ((1, 200, 260, 4, 1, 32), "bfloat16", {}),
])
def test_flash_attention_kernel_matches_plain(cuda_device, dims, dtype, kw):
    B, Sq, Sk, H, G, D = dims
    rng = np.random.default_rng(Sq + D)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(_np(rng, shape)).to(tdt).to(cuda_device)
               for shape in ((B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D)))
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    _, want_lse = _chunked_fwd(q, k, v, kw.get("causal", True),
                               kw.get("window"), kw.get("softcap"), 128,
                               kw.get("scale"))
    _assert_close_to(out, want, *TOL["flash_attention"][dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_bf16_twice_bit_identical(cuda_device):
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(_np(rng, s)).to(torch.bfloat16).cuda()
               for s in ((2, 1000, 8, 256), (2, 1000, 4, 256),
                         (2, 1000, 4, 256)))
    a = fa.flash_attention_fwd(q, k, v, softcap=50.0)
    b = fa.flash_attention_fwd(q, k, v, softcap=50.0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 48, 96, 192])
def test_flash_attention_bf16_other_head_dims_raise(cuda_device, D):
    q = torch.zeros((1, 64, 2, D), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)


def _reverse_against_plain(T, Bn, chunk, seed):
    """The fused reverse on lstm-paper at full width against its plain
    version on the card; two calls give the same bits."""
    cfg = get_config("lstm-paper")
    Dh = cfg.d_ff
    rng = np.random.default_rng(seed)
    params = params_from_numpy(init_lstm_numpy(seed, cfg.vocab, cfg.d_model,
                                               Dh), device="cuda")
    carry = tuple(torch.tensor(_np(rng, (Bn, Dh), 0.5)).cuda()
                  for _ in range(2)) + (torch.tensor(3.0).cuda(),)
    xs = tuple(torch.tensor(rng.integers(0, cfg.vocab, (T, Bn)),
                            dtype=torch.int32).cuda() for _ in range(2))
    dcarry = tuple(torch.tensor(_np(rng, (Bn, Dh), 0.1)).cuda()
                   for _ in range(2)) + (torch.tensor(1.0).cuda(),)
    body = lstm.train_chain(cfg).body
    args = (body, (False, False), params, carry, xs, None, dcarry)
    dc, dp, _ = sf.fused_reverse_segment(*args, chunk=chunk)
    dc2, dp2, _ = sf.fused_reverse_segment(*args, chunk=chunk)
    pdc, pdp, _ = sf.reverse_plain(lstm.plain_body, *args[1:], chunk=chunk)
    for a, b in zip(dc, dc2):
        assert torch.equal(a, b)
    for k in dp:
        assert torch.equal(dp[k], dp2[k])
    for a, b in zip(dc, pdc):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for k in pdp:
        scale = float(pdp[k].abs().max())
        torch.testing.assert_close(dp[k], pdp[k], rtol=1e-4,
                                   atol=1e-4 * max(scale, 1e-6))


@pytest.mark.cuda
def test_fused_reverse_pinned_shape_matches_plain(cuda_device):
    """The fused reverse at the pinned main path's segment shape (lstm-paper
    at full width, B=256, T=1000, its chunk)."""
    from repro_torch.api.autotune import default_slots
    from repro_torch.core.schedule import chunk_length

    T = 1000
    _reverse_against_plain(T, 256, chunk_length(T, default_slots(T)), 12)


@pytest.mark.cuda
def test_fused_reverse_wide_batch_matches_plain(cuda_device):
    """At B=600 the walk's 38 row tiles by 8 unit tiles outnumber the
    blocks that can be resident at once, so each block of the cooperative
    launch loops over its row tiles within a step."""
    _reverse_against_plain(6, 600, 4, 13)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,dtype,with_h0", [
    ((2, 1024, 32, 1, 64, 128, 128), "bfloat16", False),
    ((3, 300, 5, 1, 64, 128, 128), "float32", True),   # ragged chunk tail
    ((2, 256, 8, 2, 32, 64, 64), "float32", False),
])
def test_ssd_scan_kernel_matches_plain(cuda_device, dims, dtype, with_h0):
    B, T, H, G, P, N, chunk = dims
    rng = np.random.default_rng(T + H)
    tdt = getattr(torch, dtype)

    def t(shape, scale, dt=torch.float32):
        return torch.tensor(_np(rng, shape, scale)).to(dt).to(cuda_device)

    x = t((B, T, H, P), 0.5, tdt)
    dt = torch.nn.functional.softplus(t((B, T, H), 1.0))
    A = -torch.exp(t((H,), 0.3))
    b, c = t((B, T, G, N), 0.5, tdt), t((B, T, G, N), 0.5, tdt)
    h0 = t((B, H, P, N), 0.5) if with_h0 else None
    before = ssd.ssd_scan.launches
    y, h = ssd.ssd_scan(x, dt, A, b, c, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt, A, b, c, h0)
    # per head: y (B, T, H, P) over T and P, h (B, H, P, N) over P and N
    _assert_close_to(y, y_ref, *TOL["ssd_scan"][dtype], dims=(1, 3))
    _assert_close_to(h, h_ref, 2e-4, 2e-4, dims=(2, 3))


@pytest.mark.cuda
def test_ssd_scan_bf16_mamba2_layer_at_the_gates(cuda_device):
    """The tensor-core SSD scan at mamba2-370m's layer shape (B=4 of the
    ssm phase, T=4096, H=32, P=64, N=128, chunk 128): y at the bf16 gates
    and the fp32 state at (2e-4, 2e-4), per head; two calls give the same
    bits."""
    B, T, H, G, P, N, chunk = 4, 4096, 32, 1, 64, 128, 128
    rng = np.random.default_rng(14)

    def t(shape, scale, dt=torch.float32):
        return torch.tensor(_np(rng, shape, scale)).to(dt).to(cuda_device)

    bf16 = torch.bfloat16
    x = t((B, T, H, P), 0.5, bf16)
    dt = torch.nn.functional.softplus(t((B, T, H), 1.0))
    A = -torch.exp(t((H,), 0.3))
    b, c = t((B, T, G, N), 0.5, bf16), t((B, T, G, N), 0.5, bf16)
    y, h = ssd.ssd_scan(x, dt, A, b, c, chunk=chunk)
    y2, h2 = ssd.ssd_scan(x, dt, A, b, c, chunk=chunk)
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt, A, b, c)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    _assert_close_to(y, y_ref, *TOL["ssd_scan"]["bfloat16"], dims=(1, 3))
    _assert_close_to(h, h_ref, 2e-4, 2e-4, dims=(2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk", [
    (1000, None),   # the pinned main path's segment (its chunk)
    (196, 13),      # a merged length-1 tail: a chunk of 14 steps
])
def test_fused_advance_equals_the_step_loop_on_card(cuda_device, T, chunk):
    """The fused advance on lstm-paper at full width (B=256): its
    chunk-entry boundaries and exit (h, c) are, bit for bit, the states of
    one run of the step loop over the segment from the same entry, one
    step loop launch a forward chunk; two calls give the same bits, the
    loss accumulator and its boundaries included."""
    from repro_torch.api.autotune import default_slots
    from repro_torch.core.schedule import chunk_length

    if chunk is None:
        chunk = chunk_length(T, default_slots(T))
    params, tok, hs, cs = _step_loop_operands(256, T, 16)
    cfg = get_config("lstm-paper")
    rng = np.random.default_rng(17)
    tgt = torch.tensor(rng.integers(0, cfg.vocab, tok.shape),
                       dtype=torch.int32).cuda()
    carry = (hs[0].clone(), cs[0].clone(), torch.tensor(3.0).cuda())
    body = lstm.train_chain(cfg).body
    adv = sf.fused_advance_segment
    before = (adv.cell_launches, adv.cell_steps)
    outs = [adv(body, params, carry, (tok, tgt), None, chunk=chunk)
            for _ in range(2)]
    for out in outs:
        out.ready.synchronize()
    starts = sf.forward_bounds(T, chunk)[:-1]
    assert (adv.cell_launches, adv.cell_steps) == (
        before[0] + 2 * len(starts), before[1] + 2 * T)
    a, b = [list(o.carry) + list(o.boundaries) for o in outs]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    lc.lstm_cell_token_steps(tok, params["emb"], hs, cs, params["w"],
                             params["b"])
    torch.cuda.synchronize()
    out = outs[0]
    assert torch.equal(out.boundaries[0], hs[starts].cpu())
    assert torch.equal(out.boundaries[1], cs[starts].cpu())
    assert torch.equal(out.carry[0], hs[T]) and torch.equal(out.carry[1],
                                                            cs[T])


def _step_loop_operands(Bn, L, seed):
    cfg = get_config("lstm-paper")
    Dh = cfg.d_ff
    rng = np.random.default_rng(seed)
    params = params_from_numpy(init_lstm_numpy(seed, cfg.vocab, cfg.d_model,
                                               Dh), device="cuda")
    tok = torch.tensor(rng.integers(0, cfg.vocab, (L, Bn)),
                       dtype=torch.int32).cuda()
    hs = torch.empty((L + 1, Bn, Dh), device="cuda")
    cs = torch.empty_like(hs)
    hs[0] = torch.tensor(_np(rng, (Bn, Dh), 0.5)).cuda()
    cs[0] = torch.tensor(_np(rng, (Bn, Dh), 0.5)).cuda()
    return params, tok, hs, cs


@pytest.mark.cuda
def test_lstm_cell_step_loop_pinned_shape(cuda_device):
    """The step loop over one recompute chunk of the pinned main path
    (lstm-paper at full width, B=256, the chunk of T=1000) in one launch:
    each step against lstm_cell_ref (1e-5), and the same bits on two
    calls."""
    from repro_torch.api.autotune import default_slots
    from repro_torch.core.schedule import chunk_length

    L = chunk_length(1000, default_slots(1000))
    params, tok, hs, cs = _step_loop_operands(256, L, 15)
    emb, w, b = params["emb"], params["w"], params["b"]
    runs = []
    for _ in range(2):
        h2, c2 = hs.clone(), cs.clone()
        before = (lc.lstm_cell.launches, lc.lstm_cell.steps)
        lc.lstm_cell_token_steps(tok, emb, h2, c2, w, b)
        assert (lc.lstm_cell.launches, lc.lstm_cell.steps) == (
            before[0] + 1, before[1] + L)
        runs.append((h2, c2))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    h2, c2 = runs[0]
    for t in range(L):
        hr, cr = lstm_cell_ref(emb[tok[t].long()], h2[t], c2[t], w, b)
        torch.testing.assert_close(h2[t + 1], hr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(c2[t + 1], cr, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_lstm_cell_step_loop_refuses_a_grid_that_cannot_be_resident(
        cuda_device):
    """A cooperative grid larger than the card can hold at once (38 row
    tiles x 8 unit tiles at B=600, one block of 160 KB a SM) is refused by
    the launch with an error, never hung on the grid barrier."""
    params, tok, hs, cs = _step_loop_operands(600, 3, 16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        lc._token_steps(tok, params["emb"], hs, cs, params["w"],
                        params["b"], None, None, blocks_y=38)
    torch.cuda.synchronize()
    # the default grid runs the same steps
    lc.lstm_cell_token_steps(tok, params["emb"], hs, cs, params["w"],
                             params["b"])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(hs).all())


@pytest.mark.cuda
def test_chunked_attention_grads_on_card_match_cpu(cuda_device):
    """The card's forward (the kernel, with its logsumexp) feeds the same
    flash-style backward as the CPU's plain forward."""
    rng = np.random.default_rng(3)
    arrs = [_np(rng, s) for s in ((2, 96, 4, 32), (2, 96, 2, 32),
                                  (2, 96, 2, 32))]
    dout = torch.tensor(_np(rng, (2, 96, 4, 32)))
    out = {}
    for device in ("cpu", "cuda"):
        q, k, v = (torch.tensor(a, device=device).requires_grad_(True)
                   for a in arrs)
        o = chunked_attention(q, k, v, True, 40, 30.0, 32, None)
        grads = torch.autograd.grad((o * dout.to(device)).sum(), (q, k, v))
        out[device] = [o.detach().cpu()] + [g.cpu() for g in grads]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,seq,n_layers,kernel", [
    ("gemma2-2b", 2064, 4, fa.flash_attention),   # S > 2048: the kernel
    ("mamba2-370m", 64, 5, ssd.ssd_scan),
])
def test_offloaded_decoder_on_card_matches_dense(cuda_device, arch, seq,
                                                 n_layers, kernel):
    from torch.utils import _pytree as pytree

    cfg = get_config(arch, smoke=True).replace(n_layers=n_layers)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = make_batch(cfg, ShapeSpec("t", seq, 1, "train"), 0)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = model.train_loss(pytree.tree_unflatten(leaves, spec), batch)
    dense = torch.autograd.grad(loss, leaves)
    kernel.launches = 0
    v, g = api.value_and_grad_offloaded(model.train_loss, interval=2,
                                        slots=2, device="cuda")(params,
                                                                batch)
    stats = api.last_stats()
    per_step = 2 if arch == "gemma2-2b" else 1
    # forward sweep and the reverse's recompute: one launch per layer each
    assert kernel.launches == per_step * stats.advances > 0
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for a, b in zip(pytree.tree_leaves(g), dense):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def _moe_step(layers):
    """The MoE layer kernels' forward launches a chain step of ``layers``
    MoE layers (``moe_einsum``: the routing, the slots, the dispatch, the
    combine and the experts' three products)."""
    return {"moe_route": layers, "moe_slots": layers,
            "moe_dispatch": layers, "moe_combine": layers,
            "expert_fwd": 3 * layers}


# each forward kernel's backward, launched once a step's vjp
BACKWARDS = {"dense_fwd": "dense_bwd", "moe_route": "moe_route_bwd",
             "moe_dispatch": "moe_dispatch_bwd",
             "moe_combine": "moe_combine_bwd", "expert_fwd": "expert_bwd"}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers,per_step", [
    # top-1 of 4 experts with a shared expert, capacity factor 2.0: one
    # attn_moe layer a chain step (q, k, v, o and the shared expert's gate,
    # up, down)
    ("llama4-scout-17b-16e", 4, {"flash_attention": 1, "dense_fwd": 7,
                                 **_moe_step(1)}),
    # three periods of (mamba, mamba_moe, mamba, attn_moe, mamba,
    # mamba_moe, mamba, mamba_moe): a tail segment of one period
    ("jamba-v0.1-52b", 24, {"flash_attention": 1, "ssd_scan": 7,
                            "dense_fwd": 18, **_moe_step(4)}),
])
def test_offloaded_moe_decoder_on_card_matches_dense(cuda_device, arch,
                                                     n_layers, per_step):
    """The MoE and hybrid chains at SMOKE width, S > 2048 (the flash
    kernel's path): the offloaded gradient against dense autograd on the
    card, and each kernel's launches as the plan implies (the MoE layers'
    routing, slots, dispatch, combine and experts' products among them)."""
    from torch.utils import _pytree as pytree

    cfg = get_config(arch, smoke=True).replace(n_layers=n_layers)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = make_batch(cfg, ShapeSpec("t", 2064, 1, "train"), 0)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = model.train_loss(pytree.tree_unflatten(leaves, spec), batch)
    dense = torch.autograd.grad(loss, leaves)
    kernels = {"flash_attention": fa.flash_attention,
               "ssd_scan": ssd.ssd_scan, "dense_fwd": dn.dense_fwd,
               "moe_route": mk.moe_route, "moe_slots": mk.moe_slots,
               "moe_dispatch": mk.moe_dispatch, "moe_combine": mk.moe_combine,
               "expert_fwd": dn.expert_fwd}
    backwards = {name: getattr(mk, name, None) or getattr(dn, name)
                 for name in BACKWARDS.values()}
    for fn in (*kernels.values(), *backwards.values()):
        fn.launches = 0
    v, g = api.value_and_grad_offloaded(model.train_loss, interval=2,
                                        slots=2, device="cuda")(params,
                                                                batch)
    stats = api.last_stats()
    assert stats.n == cfg.n_periods
    for name, fn in kernels.items():
        # forward sweep and the reverse's recompute
        assert fn.launches == per_step.get(name, 0) * stats.advances, name
    assert all(kernels[name].launches > 0 for name in per_step)
    # the backwards (the projections', the MoE layers'): once in each
    # step's vjp
    for fwd, bwd in BACKWARDS.items():
        assert backwards[bwd].launches == per_step[fwd] * stats.n, bwd
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for a, b in zip(pytree.tree_leaves(g), dense):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.fixture
def deterministic(cuda_device):
    """Deterministic algorithms for bit-identical resume (set by the
    caller, as the front door's docs say; restored after).  Warn-only: an
    op without a deterministic version warns rather than raises, and the
    test's bit-equality asserts catch any divergence it causes."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield cuda_device
    torch.use_deterministic_algorithms(was)


@pytest.mark.cuda
def test_journaled_fused_crash_and_resume_on_card(deterministic, tmp_path):
    """The fused runner's journaled gradient on the card (its boundaries
    handed over from page-locked memory into the WAL), killed at every
    forward store and failing at every reverse fetch, then resumed: loss
    and gradients bit-identical to the fault-free journaled run, which is
    bit-identical to the unjournaled one; the resume's counters and
    ``replayed_advances`` (<= I) equal the CPU run's for the same crash."""
    from repro_torch.core import faults
    from repro_torch.core.faults import FaultPlan

    T, interval = 29, 6
    segs = -(-T // interval)
    rng = np.random.default_rng(11)
    ref = init_lstm_numpy(11, V, DX, DH)
    tok = torch.tensor(rng.integers(0, V, (B, T + 1)), dtype=torch.int32)
    kw = {"interval": interval, "slots": 3, "runner": "fused"}

    def inputs(device):
        return (params_from_numpy(ref, device=device),
                {"tokens": tok.to(device)})

    plain = api.value_and_grad_offloaded(lstm.train_chain(), device="cuda",
                                         **kw)(*inputs("cuda"))
    fault_free = api.value_and_grad_offloaded(
        lstm.train_chain(), device="cuda", journal_dir=str(tmp_path / "ok"),
        **kw)(*inputs("cuda"))
    assert torch.equal(plain[0], fault_free[0])
    for a, b in zip(plain[1].values(), fault_free[1].values()):
        assert torch.equal(a, b)
    plans = [FaultPlan(kill_writer_at_store=k) for k in range(segs + 1)] + \
        [FaultPlan(fail_get_at=j) for j in range(segs)]
    for i, plan in enumerate(plans):
        stats = {}
        for device in ("cpu", "cuda"):
            jd = str(tmp_path / f"{device}{i}")
            vg = api.value_and_grad_offloaded(
                lstm.train_chain(), device=device, journal_dir=jd, **kw)
            with pytest.raises(Exception) as ei:
                with faults.inject(plan):
                    vg(*inputs(device))
            assert faults.is_storage_fault(ei.value), ei.value
            loss, grads = api.resume_offloaded(
                lstm.train_chain(), *inputs(device), journal_dir=jd,
                device=device, **kw)
            stats[device] = api.last_stats()
            if device == "cuda":
                assert torch.equal(loss, fault_free[0]), plan
                for k, g in fault_free[1].items():
                    assert torch.equal(grads[k], g), (plan, k)
        assert stats["cuda"].replayed_advances <= interval
        for name in ("advances", "backwards", "replayed_advances",
                     "l2_stores", "l2_prefetches", "fused_segments"):
            assert getattr(stats["cuda"], name) == \
                getattr(stats["cpu"], name), (plan, name)


def _fused_on_card(captured, tok, ref, **kw):
    """One fused gradient on the card, captured or through the uncaptured
    wrappers (``segment_fused._CAPTURED``, the private switch): (loss,
    grads, stats, launch counts made)."""
    counters = (lc.lstm_cell, sf.fused_advance_segment,
                sf.fused_reverse_segment)
    before = [(f.launches, getattr(f, "cell_launches", 0),
               getattr(f, "cell_steps", getattr(f, "steps", 0)))
              for f in counters]
    was, sf._CAPTURED = sf._CAPTURED, captured
    try:
        loss, grads = api.value_and_grad_offloaded(
            lstm.train_chain(), runner="fused", device="cuda", **kw)(
            params_from_numpy(ref, device="cuda"),
            {"tokens": tok.to("cuda")})
    finally:
        sf._CAPTURED = was
    made = [(f.launches, getattr(f, "cell_launches", 0),
             getattr(f, "cell_steps", getattr(f, "steps", 0)))
            for f in counters]
    return loss, grads, api.last_stats(), [
        tuple(a - b for a, b in zip(m, b0)) for m, b0 in zip(made, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["ram", "tiered", "compressed",
                                     "journaled"])
def test_captured_fused_segments_equal_uncaptured_on_card(
        deterministic, tmp_path, storage):
    """``runner="fused"`` on the card replays captured segments
    (``segment_fused.CapturedRun``): loss and gradients bit for bit the
    uncaptured wrappers', with the same plan counters and launch counts,
    over RAM, a tiered fast tier of one state, the int8-compressed store
    and the write-ahead journal; a 29-step chain at I=6 ends in a 5-step
    tail segment (a second graph shape).  The Level-2 slot pool holds at
    most the states the store keeps in RAM (the fast tier's one, none for
    the compressed store), the prefetch depth and two more at once.  Over RAM a second captured call captures no graph,
    takes no new Level-2 slot and returns every slot it took."""
    T = 29
    rng = np.random.default_rng(12)
    ref = init_lstm_numpy(12, V, DX, DH)
    tok = torch.tensor(rng.integers(0, V, (B, T + 1)), dtype=torch.int32)
    kw = {"interval": 6, "slots": 3}
    if storage == "tiered":
        kw.update(storage="tiered", storage_dir=str(tmp_path / "slow"),
                  l2_capacity_bytes=2 * B * DH * 4 + 4)
    elif storage == "compressed":
        kw.update(storage="compressed")
    elif storage == "journaled":
        kw.update(journal_dir=str(tmp_path / "wal"))
    want = _fused_on_card(False, tok, ref, **kw)
    held = {}   # slots earlier tests' Level-2 state may still hold
    for key, pool in sf._POOLS.items():
        pool.reset_peak()
        held[key] = pool.in_use
    runs = [_fused_on_card(True, tok, ref, **kw)]
    if storage in ("tiered", "compressed"):
        key = (B, DH, torch.device("cuda", 0))
        kept = 1 if storage == "tiered" else 0   # states kept in RAM
        assert sf._POOLS[key].peak - held.get(key, 0) <= \
            kept + runs[0][2].prefetch_depth + 2
    if storage == "ram":
        captures = sf.CapturedRun.captures
        pool = sf._POOLS[(B, DH, torch.device("cuda", 0))]
        # earlier garbage holding slots (their finalizers return them)
        # is collected first, so that no slot comes back during the call
        gc.collect()
        grown, free = pool.grown, pool.free
        runs.append(_fused_on_card(True, tok, ref, **kw))
        # every slot the call took is back (others may still be held by
        # earlier tests' Level-2 state)
        assert sf.CapturedRun.captures == captures
        assert pool.grown == grown and pool.free == free
    for loss, grads, stats, made in runs:
        assert torch.equal(loss, want[0])
        for k, g in want[1].items():
            assert torch.equal(grads[k], g), k
        for name in ("advances", "backwards", "l2_stores", "host_dispatches",
                     "fused_segments", "fused_boundary_copies",
                     "l2_peak_bytes", "l2_fast_peak_bytes", "l2_evictions",
                     "l2_promotions"):
            assert getattr(stats, name) == getattr(want[2], name), name
        assert made == want[3]


@pytest.mark.cuda
def test_captured_fused_resume_on_card(deterministic, tmp_path):
    """A journaled captured gradient killed at its second forward store,
    resumed with ``resume_offloaded``: bit for bit the fault-free captured
    run, which is bit for bit the uncaptured one."""
    from repro_torch.core import faults
    from repro_torch.core.faults import FaultPlan

    T = 29
    rng = np.random.default_rng(13)
    ref = init_lstm_numpy(13, V, DX, DH)
    tok = torch.tensor(rng.integers(0, V, (B, T + 1)), dtype=torch.int32)
    kw = {"interval": 6, "slots": 3, "runner": "fused", "device": "cuda"}

    def inputs():
        return (params_from_numpy(ref, device="cuda"),
                {"tokens": tok.to("cuda")})

    uncaptured = _fused_on_card(False, tok, ref, interval=6, slots=3)
    loss, grads = api.value_and_grad_offloaded(
        lstm.train_chain(), journal_dir=str(tmp_path / "ok"), **kw)(
        *inputs())
    assert torch.equal(loss, uncaptured[0])
    jd = str(tmp_path / "wal")
    with pytest.raises(Exception) as ei:
        with faults.inject(FaultPlan(kill_writer_at_store=2)):
            api.value_and_grad_offloaded(lstm.train_chain(), journal_dir=jd,
                                         **kw)(*inputs())
    assert faults.is_storage_fault(ei.value), ei.value
    r_loss, r_grads = api.resume_offloaded(lstm.train_chain(), *inputs(),
                                           journal_dir=jd, **kw)
    assert torch.equal(r_loss, loss)
    for k, g in grads.items():
        assert torch.equal(r_grads[k], g) and torch.equal(
            g, uncaptured[1][k]), k
    assert 0 < api.last_stats().replayed_advances <= 6


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [4, 7])
def test_scan_engine_on_card_matches_cpu(cuda_device, interval):
    """``engine="scan"`` on ``lstm-paper``-shaped SMOKE weights: the card's
    gradient against the CPU's (loss 1e-5, leaves 1e-4 of their scale), the
    same plan, one boundary a segment, every one of them page-locked on the
    card, and ``lstm_cell`` launched once a step run (forward and the
    segments' recompute, twice where a segment recomputes in inner chunks).
    """
    T = 29
    ref = init_lstm_numpy(3, V, DX, DH)
    tok = np.random.default_rng(3).integers(0, V, (B, T + 1)).astype(
        np.int32)
    out = {}
    for device in ("cpu", "cuda"):
        lc.lstm_cell.launches = 0
        vg = api.value_and_grad_offloaded(
            lstm.train_chain(), engine="scan", interval=interval, slots=4,
            device=device)
        v, g = vg(params_from_numpy(ref, device=device),
                  {"tokens": torch.as_tensor(tok, device=device)})
        rec, plan = api.last_scan(), api.last_plan()
        assert api.last_stats() is None
        assert rec.boundaries_offloaded == plan.num_segments
        out[device] = (v.cpu(), {k: t.cpu() for k, t in g.items()},
                       plan.plan_id, rec, lc.lstm_cell.launches, plan)
    v_cpu, g_cpu, pid_cpu, _, _, plan = out["cpu"]
    v_card, g_card, pid_card, rec, launches, _ = out["cuda"]
    assert pid_card == pid_cpu
    assert rec.pinned_boundaries == plan.num_segments
    recompute = sum(s.length * (2 if plan.inner_chunk(s) else 1)
                    for s in plan.segments)
    assert launches == T + recompute
    torch.testing.assert_close(v_card, v_cpu, rtol=1e-5, atol=0)
    for k, want in g_cpu.items():
        torch.testing.assert_close(g_card[k], want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_scan_boundaries_are_page_locked_and_flat(cuda_device):
    """The scan engine's Level-2 boundaries on the card: one page-locked
    slot a segment (the pool's slots, reused by the next call), each copied
    back once; the device memory a call holds at its peak does not grow
    with the chain."""
    from repro_torch.core import multistage_scan as ms
    from repro_torch.core import offload as ofl

    torch.manual_seed(0)
    W = (torch.randn(64, 64, device="cuda") * 0.1).requires_grad_(True)

    def body(p, c, x):
        c = torch.tanh(c @ p + x)
        return c, (c ** 2).sum()

    peaks = {}
    for n in (256, 512):
        xs = torch.randn(n, 32, 64, device="cuda") * 0.1
        c0 = torch.zeros(32, 64, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, ls = ms.multistage_scan(body, c0, xs, params=W, interval=16)
        (g,) = torch.autograd.grad(ls.sum(), [W])
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated() - base   # xs in base
        rec = ofl.last_record()
        assert rec.boundaries_offloaded == rec.pinned_boundaries == n // 16
        assert rec.h2d_bytes == rec.d2h_bytes == n // 16 * 32 * 64 * 4
        assert bool(g.isfinite().all())
    # 16 more segments: at most a few kB of bookkeeping, no activations
    assert peaks[512] - peaks[256] < 64 * 1024, peaks


@pytest.mark.cuda
def test_streamed_moe_on_card_equals_unstreamed(cuda_device):
    """``offload_params="moe_experts"`` on phi3.5-moe SMOKE at 4 layers, the
    expert weights on the host: the loss and every gradient leaf bit for
    bit the unstreamed call's on the card (the experts on the card), the
    host leaves left where they were, their gradients on the card, each
    expert blob read once a phase."""
    from torch.utils import _pytree as pytree

    from repro_torch.api.frontend import _expert_leaf_ids

    cfg = get_config("phi3.5-moe-42b", smoke=True).replace(n_layers=4)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = make_batch(cfg, ShapeSpec("t", 2064, 1, "train"), 0)
    v, g = api.value_and_grad_offloaded(model.train_loss, interval=2,
                                        device="cuda")(params, batch)
    leaves, spec = pytree.tree_flatten(params)
    ids = set(_expert_leaf_ids(params))
    host = pytree.tree_unflatten(
        [t.cpu() if i in ids else t for i, t in enumerate(leaves)], spec)
    fa.flash_attention.launches = 0
    vs, gs = api.value_and_grad_offloaded(
        model.train_loss, interval=2, offload_params="moe_experts",
        device="cuda")(host, batch)
    stats = api.last_stats()
    assert torch.equal(vs, v)
    for a, b in zip(pytree.tree_leaves(gs), pytree.tree_leaves(g)):
        assert torch.equal(a, b)
    host_leaves = pytree.tree_leaves(host)
    assert all(not host_leaves[i].is_cuda for i in ids)
    assert all(pytree.tree_leaves(gs)[i].is_cuda for i in ids)
    expert_bytes = sum(host_leaves[i].numel() * 4 for i in ids)
    assert stats.param_bytes_moved == 2 * expert_bytes
    assert stats.param_prefetches == 2 * api.last_plan().num_segments
    assert fa.flash_attention.launches == stats.advances > 0


@pytest.mark.cuda
def test_budget_2d_plan_on_card_splits_jamba_period(cuda_device):
    """A budget-driven 2D gradient of jamba at SMOKE width (24 layers,
    S=2064: the flash kernel's path) under 60% of one 8-layer period's
    bytes: the plan splits the period (``layer_chunks > 1``), the gradient
    matches dense autograd on the card, the inner counters equal the
    perfmodel's, and each kernel launches once a layer run: the forward
    sweep, the reverse's replay and the inner recompute."""
    from torch.utils import _pytree as pytree

    from repro_torch.analysis.byte_profile import chain_step_byte_profile
    from repro_torch.api.chain import index_xs
    from repro_torch.core import perfmodel as pm

    cfg = get_config("jamba-v0.1-52b", smoke=True).replace(n_layers=24)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = make_batch(cfg, ShapeSpec("t", 2064, 1, "train"), 0)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = model.train_loss(pytree.tree_unflatten(leaves, spec), batch)
    dense = torch.autograd.grad(loss, leaves)
    chain = model.train_chain
    carry0, xs = chain.prelude(params, batch)
    sb, lb, hb = chain_step_byte_profile(chain, params, carry0,
                                         index_xs(xs, 0), batch)
    kernels = {"flash_attention": fa.flash_attention,
               "ssd_scan": ssd.ssd_scan}
    per_step = {"flash_attention": 1, "ssd_scan": 7}
    for fn in kernels.values():
        fn.launches = 0
    v, g = api.value_and_grad_offloaded(
        model.train_loss, interval=2, slots=2, device="cuda",
        step_memory_budget=int(0.6 * sum(lb)))(params, batch)
    stats, inner = api.last_stats(), api.last_plan().inner
    assert inner is not None and inner.layer_chunks > 1
    assert stats.inner_recomputed_layers == \
        pm.inner_recomputed_layers_model(stats.n, inner)
    assert stats.inner_peak_bytes == \
        int(pm.inner_boundary_bytes_model(inner, sb))
    assert stats.inner_recompute_factor == 1.0
    for name, fn in kernels.items():
        assert fn.launches == per_step[name] * (stats.advances + stats.n), \
            name
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for a, b in zip(pytree.tree_leaves(g), dense):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_byte_profile_allocates_no_device_memory(cuda_device):
    """The byte profile of gemma2-2b's chain at full width (B=2, S=4096,
    its weights on the card) runs on meta tensors: the card's allocated
    bytes and their peak stay where they were, and the numbers equal the
    profile of the same chain's meta copy made on the host."""
    from repro_torch.analysis.byte_profile import (chain_step_byte_profile,
                                                   to_meta)
    from repro_torch.api.chain import index_xs
    from repro_torch.configs import SHAPES

    cfg = get_config("gemma2-2b").replace(n_layers=2)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    shape = SHAPES["train_4k"]
    batch = make_batch(cfg, ShapeSpec("t", shape.seq_len, 2, "train"), 0)
    chain = model.train_chain
    with torch.no_grad():
        carry0, xs = chain.prelude(params, batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prof = chain_step_byte_profile(chain, params, carry0, index_xs(xs, 0),
                                   batch)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    assert torch.cuda.max_memory_allocated() == held
    host = chain_step_byte_profile(
        chain, to_meta(params), to_meta(carry0), to_meta(index_xs(xs, 0)),
        to_meta(batch))
    assert prof == host
    assert prof[0] == 2 * shape.seq_len * cfg.d_model * 2 + 4


# ------------------------------------------- generic-body fused segments

def _ref_lstm_chain(Bn, Dx, Dh):
    """``tests/test_kernels.py:191``'s chain: the body is
    ``lstm_cell_ref`` itself."""
    from repro_torch.api.chain import ChainSpec

    def prelude(p, batch):
        z = batch["xs"].new_zeros((Bn, Dh))
        return (z, z, z.new_zeros(())), batch["xs"]

    def body(p, carry, x, batch):
        h, c, acc = carry
        h, c = lstm_cell_ref(x, h, c, p["w"], p["b"])
        return (h, c, acc + torch.sum(h ** 2))

    return ChainSpec(prelude, body, lambda p, c, b: c[2], name="ref-lstm")


def _ssm_chain(Bn, D):
    """``tests/test_kernels.py:220``'s diagonal SSM chain with float
    inputs (the reverse writes their cotangents)."""
    from repro_torch.api.chain import ChainSpec

    def prelude(p, batch):
        return ((batch["xs"].new_zeros((Bn, D)),
                 batch["xs"].new_zeros(())), batch["xs"])

    def body(p, carry, x, batch):
        h, acc = carry
        h = torch.exp(-torch.nn.functional.softplus(p["logA"])) * h \
            + x @ p["Bm"]
        return (h, acc + torch.mean((h @ p["Cm"]) ** 2))

    return ChainSpec(prelude, body, lambda p, c, b: c[1], name="ssm")


def _fused_against_compiled(spec, params, batch, interval, slots):
    """``runner="fused"`` and ``runner="compiled"`` on the card at one
    schedule: the loss bit for bit, each gradient leaf within 1e-4 of its
    max |g|, the plan equal, and the generic kernels launched once a
    forward chunk and once a reverse chunk."""
    from torch.utils import _pytree as pytree

    from repro_torch.core.schedule import chunk_length

    out = {}
    for runner in ("compiled", "fused"):
        e0, f0 = sg.entry_store.launches, sg.fold.launches
        vg = api.value_and_grad_offloaded(spec, interval=interval,
                                          slots=slots, runner=runner,
                                          device="cuda")
        loss, grads = vg(params, batch)
        out[runner] = (loss, pytree.tree_leaves(grads), api.last_plan(),
                       api.last_stats(), (sg.entry_store.launches - e0,
                                          sg.fold.launches - f0))
    loss, grads, plan, stats, launches = out["fused"]
    assert torch.equal(loss, out["compiled"][0])
    assert plan.plan_id == out["compiled"][2].plan_id
    for a, b in zip(grads, out["compiled"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
    fwd = rev = 0
    for seg in plan.segments:
        chunk = chunk_length(seg.length, slots) or seg.length
        fwd += len(sf.forward_bounds(seg.length, chunk)) - 1
        rev += sf.reverse_layout(seg.length, chunk)[1]
    assert launches == (fwd, rev) and out["compiled"][4] == (0, 0)
    assert stats.fused_segments == 2 * plan.num_segments
    assert stats.fused_boundary_copies == fwd + 2 * rev


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ref_lstm", "ssm"])
def test_generic_chains_fused_on_card_match_compiled(cuda_device, kind):
    rng = np.random.default_rng(7)
    if kind == "ref_lstm":
        Bn, Dx, Dh, T = 2, 4, 6, 29
        spec = _ref_lstm_chain(Bn, Dx, Dh)
        params = {"w": torch.tensor(_np(rng, (Dx + Dh, 4 * Dh), 0.2)),
                  "b": torch.zeros(4 * Dh)}
        xs, interval = _np(rng, (T, Bn, Dx), 0.5), 8
    else:
        Bn, D, T = 3, 8, 41
        spec = _ssm_chain(Bn, D)
        params = {"logA": torch.tensor(_np(rng, (D,), 0.1)),
                  "Bm": torch.tensor(_np(rng, (D, D), 0.3)),
                  "Cm": torch.tensor(_np(rng, (D, D), 0.3))}
        xs, interval = _np(rng, (T, Bn, D), 0.4), 16
    _fused_against_compiled(spec, _dev(params, "cuda"),
                            {"xs": torch.tensor(xs, device="cuda")},
                            interval, 4)


@pytest.mark.cuda
def test_generic_jamba_fused_on_card_matches_compiled(cuda_device):
    """jamba at SMOKE width, 24 layers (three 8-layer periods), S > 2048
    (the flash kernel's path): ``runner="fused"`` against
    ``runner="compiled"`` on the card."""
    cfg = get_config("jamba-v0.1-52b", smoke=True).replace(n_layers=24)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = make_batch(cfg, ShapeSpec("t", 2064, 1, "train"), 0)
    _fused_against_compiled(model.train_loss, params, batch, 2, 2)


@pytest.mark.cuda
def test_generic_phi35_moe_fused_on_card_matches_compiled(cuda_device):
    """phi3.5-moe at SMOKE width, 4 layers, S > 2048: ``runner="fused"``
    (the MoE layer in its kernels) against ``runner="compiled"`` on the
    card, and the MoE kernels launched as the fused plan implies: the
    forward ones each time a step runs (forward chunks and the reverse's
    recompute), the backward ones once a step's vjp."""
    cfg = get_config("phi3.5-moe-42b", smoke=True).replace(n_layers=4)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = make_batch(cfg, ShapeSpec("t", 2064, 1, "train"), 0)
    fwd = (mk.moe_route, mk.moe_slots, mk.moe_dispatch, mk.moe_combine)
    bwd = (mk.moe_route_bwd, mk.moe_dispatch_bwd, mk.moe_combine_bwd)
    for fn in fwd + bwd + (dn.expert_fwd, dn.expert_bwd):
        fn.launches = 0
    vg = api.value_and_grad_offloaded(model.train_loss, interval=2, slots=2,
                                      runner="fused", device="cuda")
    vg(params, batch)
    plan = api.last_plan()
    steps = sum(seg.length for seg in plan.segments)
    # two segments of one chunk: each step runs forward, then again in its
    # segment's reverse (the chunk's checkpointed vjp)
    assert [fn.launches for fn in fwd] == [2 * steps] * 4
    assert [fn.launches for fn in bwd] == [steps] * 3
    assert (dn.expert_fwd.launches, dn.expert_bwd.launches) == (
        6 * steps, 3 * steps)
    _fused_against_compiled(model.train_loss, params, batch, 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("D,kw", [(256, {"softcap": 50.0, "window": 100,
                                         "scale": 0.0625}),
                                  (64, {"causal": False})])
def test_flash_attention_bwd_matches_plain(cuda_device, dtype, tol, D, kw):
    """The attention backward kernel against ``_chunked_bwd`` on the
    forward kernel's ``out`` and ``lse`` (dq, dk, dv within ``tol`` of the
    plain version's max |value|), two calls bit for bit."""
    from repro_torch.models.attention import _chunked_bwd

    rng = np.random.default_rng(D)
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.tensor(_np(rng, s), device="cuda").to(dt)
                     for s in ((2, 300, 4, D), (2, 300, 2, D),
                               (2, 300, 2, D), (2, 300, 4, D)))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = _chunked_bwd(kw.get("causal", True), kw.get("window"),
                        kw.get("softcap"), 64, kw.get("scale"),
                        (q, k, v, out, lse), dout)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert float(err) <= tol
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_layer_kernels_match_plain_under_autograd(cuda_device, dtype, tol):
    """``layers.rmsnorm`` (with the residual), ``geglu``/``swiglu`` and
    ``apply_rope_qk`` on the card (their kernels, forward and backward)
    against the same functions on the CPU (the plain versions under
    autograd), values and gradients within ``tol`` of the CPU's max
    |value|, each kernel launched once each way."""
    from repro_torch.kernels import glu as glu_mod
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rope as rope_mod
    from repro_torch.models import layers

    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    dts = layers.DTypes(compute=dt)
    arrs = [_np(rng, s) for s in ((2, 64, 96), (2, 64, 96), (96,),
                                  (2, 64, 80), (2, 64, 80), (2, 64, 4, 32),
                                  (2, 64, 2, 32))]
    counters = (rn.rmsnorm, rn.rmsnorm_bwd, glu_mod.glu, glu_mod.glu_bwd,
                rope_mod.rope, rope_mod.rope_bwd)
    results = {}
    for device in ("cpu", "cuda"):
        x, res, sc, gate, up, q, k = (
            torch.tensor(a, device=device).to(torch.float32 if i == 2
                                               else dt).requires_grad_(True)
            for i, a in enumerate(arrs))
        cos, sin = layers.rope_table(64, 32, device=device)
        before = [c.launches for c in counters]
        outs = [layers.rmsnorm({"scale": sc}, x, dt=dts, residual=res),
                layers.geglu(gate, up), layers.swiglu(gate, up),
                *layers.apply_rope_qk(q, k, cos, sin)]
        loss = sum((o.float() * (i + 1)).sum() for i, o in enumerate(outs))
        grads = torch.autograd.grad(loss, (x, res, sc, gate, up, q, k))
        launched = [c.launches - n for c, n in zip(counters, before)]
        assert launched == ([1, 1, 2, 2, 1, 1] if device == "cuda"
                            else [0] * 6)
        results[device] = [t.detach().float().cpu()
                           for t in (*outs, *grads)]
    for a, b in zip(results["cuda"], results["cpu"]):
        assert float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_kernels_match_plain_under_autograd(cuda_device, dtype,
                                                         tol, with_state):
    """``ssm.mamba2_block`` on the card (the SSD scan and its backward, the
    causal conv, the step sizes and the gated norm, each a kernel both
    ways; with a carried conv window and SSD state too) against the same
    block on the CPU (the plain versions under autograd): the output, the
    new state and every gradient within ``tol`` of the CPU's max |value|,
    each kernel launched once each way."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import dt_softplus as ds
    from repro_torch.kernels import gated_norm as gn
    from repro_torch.models import layers, ssm as ssm_mod

    d, s = 64, dict(d_state=16, headdim=16, expand=2, ngroups=2, conv_k=4)
    Bn, T = 2, 48
    dt = getattr(torch, dtype)
    dts = layers.DTypes(compute=dt)
    base = ssm_mod.init_mamba2(torch.Generator().manual_seed(3), d, **s)
    rng = np.random.default_rng(8)
    x0 = _np(rng, (Bn, T, d))
    conv_dim = 2 * d + 2 * s["ngroups"] * s["d_state"]
    st0 = (_np(rng, (Bn, s["conv_k"] - 1, conv_dim)),
           _np(rng, (Bn, 2 * d // s["headdim"], s["headdim"], s["d_state"]),
               0.3))
    counters = (ssd.ssd_scan, ssd.ssd_scan_bwd, cc.causal_conv,
                cc.causal_conv_bwd, ds.dt_softplus, ds.dt_softplus_bwd,
                gn.gated_norm, gn.gated_norm_bwd)
    results = {}
    for device in ("cpu", "cuda"):
        leaves, spec = pytree.tree_flatten(
            pytree.tree_map(lambda t: t.to(device), base))
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        x = torch.tensor(x0, device=device).to(dt).requires_grad_(True)
        state = tuple(torch.tensor(a, device=device).requires_grad_(True)
                      for a in st0) if with_state else None
        before = [c.launches for c in counters]
        out, (cs, hs) = ssm_mod.mamba2_block(
            pytree.tree_unflatten(leaves, spec), x, chunk=16, dt=dts,
            state=state, return_state=True, **s)
        loss = (out.float().sum() + (cs * 0.5).sum()
                + (hs * 0.25).sum())
        wrt = leaves + [x] + (list(state) if with_state else [])
        grads = torch.autograd.grad(loss, wrt)
        launched = [c.launches - n for c, n in zip(counters, before)]
        assert launched == ([1] * 8 if device == "cuda" else [0] * 8)
        results[device] = [t.detach().float().cpu()
                           for t in (out, cs, hs, *grads)]
    for i, (a, b) in enumerate(zip(results["cuda"], results["cpu"])):
        assert float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) <= tol, i


@pytest.mark.cuda
@pytest.mark.parametrize("dims,dtype,with_h0", [
    ((2, 300, 4, 2, 32, 64, 64), "float32", True),
    ((2, 256, 4, 1, 64, 128, 128), "bfloat16", False),
])
def test_ssd_scan_bwd_matches_plain(cuda_device, dims, dtype, with_h0):
    """The SSD backward kernel against autograd over the plain chunked
    form: every leaf within 1e-4 (fp32) or 3e-2 (bf16) of its max |value|,
    two calls bit for bit."""
    B, T, H, G, P, N, chunk = dims
    rng = np.random.default_rng(T)
    dt_ = getattr(torch, dtype)

    def t(shape, scale=1.0, dtype=dt_):
        return torch.tensor(_np(rng, shape, scale), device="cuda").to(dtype)

    f32 = torch.float32
    args = (t((B, T, H, P), 0.5), torch.nn.functional.softplus(
        t((B, T, H), dtype=f32)), -torch.exp(t((H,), 0.3, f32)),
        t((B, T, G, N), 0.5), t((B, T, G, N), 0.5),
        t((B, H, P, N), 0.5, f32) if with_h0 else None, t((B, T, H, P)),
        t((B, H, P, N), dtype=f32))
    got = ssd.ssd_scan_bwd(*args, chunk=chunk)
    want = ssd.ssd_scan_bwd_plain(*args, chunk=chunk)
    tol = 1e-4 if dtype == "float32" else 3e-2
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert a.dtype == b.dtype and float(err) <= tol
    again = ssd.ssd_scan_bwd(*args, chunk=chunk)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers,mamba", [
    ("mamba2-370m", 5, 1),
    # three periods of 8 layers, 7 of them mamba or mamba_moe
    ("jamba-v0.1-52b", 24, 7),
])
def test_mamba_layers_run_their_kernels_on_card(cuda_device, arch, n_layers,
                                                mamba):
    """mamba2-370m and jamba at SMOKE width: the offloaded gradient on the
    card against dense autograd (loss 1e-5, leaves 1e-4 of their max |g|),
    each of the mamba layers' kernels launched as the plan implies: the
    forward ones a mamba layer each time a step runs, the backward ones a
    mamba layer a step's vjp."""
    from torch.utils import _pytree as pytree

    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import dt_softplus as ds
    from repro_torch.kernels import gated_norm as gn

    cfg = get_config(arch, smoke=True).replace(n_layers=n_layers)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    batch = make_batch(cfg, ShapeSpec("t", 2064, 1, "train"), 0)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = model.train_loss(pytree.tree_unflatten(leaves, spec), batch)
    dense = torch.autograd.grad(loss, leaves)
    fwd = (ssd.ssd_scan, cc.causal_conv, ds.dt_softplus, gn.gated_norm)
    bwd = (ssd.ssd_scan_bwd, cc.causal_conv_bwd, ds.dt_softplus_bwd,
           gn.gated_norm_bwd)
    for fn in fwd + bwd:
        fn.launches = 0
    v, g = api.value_and_grad_offloaded(model.train_loss, interval=2,
                                        slots=2, device="cuda")(params,
                                                                batch)
    stats, plan = api.last_stats(), api.last_plan()
    steps = sum(seg.length for seg in plan.segments)
    assert [fn.launches for fn in fwd] == [mamba * stats.advances] * 4
    assert [fn.launches for fn in bwd] == [mamba * steps] * 4
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for a, b in zip(pytree.tree_leaves(g), dense):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(77, 64, 128),        # a smoke shape
                                   (8192, 2304, 9216)])  # gemma2-2b's gate
def test_dense_kernel_matches_plain(cuda_device, M, K, N):
    """``dense_fwd`` and ``dense_bwd`` (x, dy bf16; w the fp32 parameter,
    cast in the load) against the plain version on the card (cuBLAS with
    fp32 reductions), per element at (1e-2, 1e-3): both round one fp32 sum
    to bf16; two calls bit for bit; dw in w's dtype."""
    rng = np.random.default_rng(M + N)
    x = torch.tensor(_np(rng, (M, K)), device="cuda").to(torch.bfloat16)
    w = torch.tensor(_np(rng, (K, N), K ** -0.5), device="cuda")
    dy = torch.tensor(_np(rng, (M, N)), device="cuda").to(torch.bfloat16)
    got = (dn.dense_fwd(x, w), *dn.dense_bwd(dy, x, w))
    again = (dn.dense_fwd(x, w), *dn.dense_bwd(dy, x, w))
    mm = torch.backends.cuda.matmul
    was = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        want = (dn.dense_fwd_plain(x, w), *dn.dense_bwd_plain(dy, x, w))
    finally:
        mm.allow_bf16_reduced_precision_reduction = was
    assert got[2].dtype == torch.float32
    for a, b in zip(got, want):
        _assert_close_to(a, b, 1e-2, 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
