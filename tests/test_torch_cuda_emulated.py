"""The CUDA kernels' sources, run on the CPU under an emulation of the CUDA
runtime (``tests/cuda_emu/``), against their plain versions.

``src/repro_torch/kernels/csrc/*.cu`` are rewritten only where the C++
compiler cannot read CUDA (``kernel<<<grid, block, ...>>>(args)`` becomes a
call of the emulator's launcher) and compiled with ``g++``; every CUDA
thread is a host thread.  The wrappers' card paths then run unchanged on
CPU tensors, with the CUDA-only pieces of PyTorch (page-locked memory,
streams, events) stubbed.  This checks the kernels' arithmetic, indexing,
masking and synchronisation order here; it does not check ``nvcc``, speed
or the card's memory model (``chip_smoke.py`` and ``test_torch_cuda.py`` do,
on the card).  Tolerances as in ``test_torch_kernels.py``.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.convert import init_lstm_numpy, params_from_numpy
from repro_torch.core.schedule import chunk_length
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import segment_fused as sf
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import lstm_cell_ref
from repro_torch.models import lstm
from repro_torch.models.attention import _chunked_fwd

ROOT = pathlib.Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
V, DX, DH = 17, 8, 12
T_BODY = lstm.train_chain().body


def _split_top(text):
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<[" and 1 or 0
        depth -= ch in ")>]" and 1 or 0
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return [p.strip() for p in parts + [cur]]


def _to_cpp(source: str) -> str:
    source = source.replace("extern __shared__ float smem[];", "")

    def launch(m):
        grid, block = _split_top(m.group(2))[:2]
        return (f"emu_launch(dim3({grid}), dim3({block}), [&]() "
                f"{{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"([\w:]+(?:<[\w:, ]+>)?)<<<(.*?)>>>\((.*?)\);", launch,
                  source, flags=re.S)


def _compile(source: str, out: pathlib.Path, name: str):
    """A kernel source compiled with g++ against the emulated runtime and
    loaded; skips the test where g++ or C++20's <barrier> is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    cpp = out / f"{name}.cpp"
    cpp.write_text(_to_cpp(source))
    so = out / f"lib{name}.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", f"-I{EMU}", f"-I{build.CSRC}", str(cpp),
         "-o", str(so)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0 and "barrier" in res.stderr:
        pytest.skip("g++ lacks C++20 <barrier>")
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.repro_error_string.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_emu")
    return {name: _compile((build.CSRC / src).read_text(), out, name)
            for name, src in build.SOURCES.items()}


class _Event:
    def record(self, *args):
        pass

    def synchronize(self):
        pass


class _TorchOnHost:
    """``torch`` as the wrappers see it, with the card-only calls stubbed."""

    cuda = types.SimpleNamespace(Event=_Event,
                                 current_stream=lambda *args: None)

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*args, pin_memory=False, **kwargs):
        return torch.empty(*args, **kwargs)


@pytest.fixture
def card_paths(emulated_libs, monkeypatch):
    """Route the wrappers' CUDA paths to the emulated kernels."""
    monkeypatch.setattr(build, "load", lambda name: emulated_libs[name])
    monkeypatch.setattr(build, "stream_ptr",
                        lambda device=None: ctypes.c_void_p(0))
    monkeypatch.setattr(sf, "torch", _TorchOnHost())
    monkeypatch.setattr(sf, "_on_cpu", lambda tree: False)
    monkeypatch.setattr(lc, "lstm_cell_token_steps",
                        lambda tok, emb, hs, cs, w, b, *, xh=None,
                        acts=None, barrier=None, entry=None: lc._token_steps(
                            tok, emb, hs, cs, w, b, xh, acts, barrier, entry))


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("Bn,Dx,Dh,dtype", [
    (37, 8, 40, torch.float32),    # ragged batch and unit edges
    (5, 16, 32, torch.bfloat16),
])
def test_lstm_cell_kernel_source(card_paths, Bn, Dx, Dh, dtype):
    rng = np.random.default_rng(Bn)
    x, h, c, w, b = [torch.tensor(a).to(dtype) for a in (
        _np(rng, (Bn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), 0.1), _np(rng, (4 * Dh,), 0.1))]
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    before = lc.lstm_cell.launches
    lc._launch("lstm_cell_f32" if dtype == torch.float32 else
               "lstm_cell_bf16", x, None, h, c, w, b, h_out, c_out, None,
               None)
    assert lc.lstm_cell.launches == before + 1
    hp, cp = lc.lstm_cell(x, h, c, w, b)   # the plain version (CPU)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(h_out.float(), hp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(c_out.float(), cp.float(), rtol=tol, atol=tol)


def _check_token_steps(Bn, Dx, Dh, Vn, L, seed, **kw):
    """``L`` steps of the step loop (the fused reverse's recompute) as one
    call, against ``lstm_cell_ref`` step by step: each step's states, [x, h]
    rows and gate activations."""
    rng = np.random.default_rng(seed)
    emb, h, c, w, b = [torch.tensor(a) for a in (
        _np(rng, (Vn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), 0.1), _np(rng, (4 * Dh,), 0.1))]
    tok = torch.tensor(rng.integers(0, Vn, (L, Bn)), dtype=torch.int32)
    hs, cs = torch.full((L + 1, Bn, Dh), -7.0), torch.full((L + 1, Bn, Dh),
                                                            -7.0)
    hs[0], cs[0] = h, c
    xh = torch.full((L, Bn, Dx + Dh), -7.0)
    acts = torch.full((L, Bn, 4 * Dh), -7.0)
    before = (lc.lstm_cell.launches, lc.lstm_cell.steps)
    lc._token_steps(tok, emb, hs, cs, w, b, xh, acts, **kw)
    assert (lc.lstm_cell.launches, lc.lstm_cell.steps) == (
        before[0] + 1, before[1] + L)
    for t in range(L):
        x = emb[tok[t].long()]
        hr, cr = lstm_cell_ref(x, hs[t], cs[t], w, b)
        torch.testing.assert_close(hs[t + 1], hr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cs[t + 1], cr, rtol=1e-5, atol=1e-5)
        assert torch.equal(xh[t], torch.cat([x, hs[t]], 1))
        i, f, o, g = (torch.cat([x, hs[t]], 1) @ w + b).chunk(4, 1)
        torch.testing.assert_close(
            acts[t], torch.cat([torch.sigmoid(i), torch.sigmoid(f + 1),
                                torch.sigmoid(o), torch.tanh(g)], 1),
            rtol=1e-5, atol=1e-5)


def test_lstm_cell_gather_variant_writes_its_side_outputs(card_paths):
    """Three steps of the step loop in one call, a ragged batch and unit
    tile (B=9, Dh=36)."""
    _check_token_steps(9, 8, 36, 11, 3, seed=3)


@pytest.mark.parametrize("Bn,Dx,Dh,L,blocks_y", [
    (70, 8, 40, 4, 0),   # 5 row tiles on 2 resident row blocks: each loops
    (37, 6, 20, 3, 0),   # Dx, Dh not multiples of 4: the 4-byte copies
    (20, 8, 12, 3, 5),   # more row blocks than row tiles: idle blocks
])
def test_lstm_cell_step_loop(card_paths, Bn, Dx, Dh, L, blocks_y):
    _check_token_steps(Bn, Dx, Dh, 13, L, seed=Bn, blocks_y=blocks_y)


def test_lstm_cell_step_loop_equals_single_steps(card_paths):
    """A step of the loop and the single-step kernel take a slice's rows
    in the same order: the same bits."""
    rng = np.random.default_rng(4)
    Bn, Dx, Dh, Vn, L = 21, 8, 40, 9, 2
    emb, w, b = [torch.tensor(a) for a in (
        _np(rng, (Vn, Dx)), _np(rng, (Dx + Dh, 4 * Dh), 0.1),
        _np(rng, (4 * Dh,), 0.1))]
    tok = torch.tensor(rng.integers(0, Vn, (L, Bn)), dtype=torch.int32)
    hs = torch.tensor(_np(rng, (L + 1, Bn, Dh)))
    cs = torch.tensor(_np(rng, (L + 1, Bn, Dh)))
    lc._token_steps(tok, emb, hs, cs, w, b, None, None)
    h, c = hs[0].clone(), cs[0].clone()
    for t in range(L):
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
        lc._launch("lstm_cell_f32", emb[tok[t].long()].contiguous(), None,
                   h, c, w, b, h_out, c_out, None, None)
        assert torch.equal(h_out, hs[t + 1]) and torch.equal(c_out, cs[t + 1])
        h, c = h_out, c_out


def _segment(T, Bn, seed):
    rng = np.random.default_rng(seed)
    params = params_from_numpy(init_lstm_numpy(seed, V, DX, DH),
                               device="cpu")
    carry = (torch.tensor(_np(rng, (Bn, DH), 0.5)),
             torch.tensor(_np(rng, (Bn, DH), 0.5)), torch.tensor(1.5))
    xs = (torch.tensor(rng.integers(0, V, (T, Bn)), dtype=torch.int32),
          torch.tensor(rng.integers(0, V, (T, Bn)), dtype=torch.int32))
    dcarry = (torch.tensor(_np(rng, (Bn, DH), 0.1)),
              torch.tensor(_np(rng, (Bn, DH), 0.1)), torch.tensor(0.7))
    return params, carry, xs, dcarry


@pytest.mark.parametrize("T,chunk,Bn", [
    (23, 5, 5),    # uneven chunk tail; a ragged second row block
    (21, 5, 3),    # length-1 tail (merged forward, its own chunk reversed)
    (6, 6, 4),     # one chunk
    (1, 4, 3),     # one step
    (4, 9, 2),     # chunk > T: one chunk of T steps
    (9, 4, 2),     # two chunks, the second of chunk + 1 steps (merged tail)
])
def test_fused_segment_kernel_sources(card_paths, T, chunk, Bn):
    params, carry, xs, dcarry = _segment(T, Bn, seed=T)
    out = sf.fused_advance_segment(T_BODY, params, carry, xs, None,
                                   chunk=chunk)
    ref = sf.advance_plain(T_BODY, params, carry, xs, None, chunk=chunk)
    for a, b in zip(list(out.carry) + list(out.boundaries),
                    list(ref.carry) + list(ref.boundaries)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dc, dp, dxd = sf.fused_reverse_segment(
        T_BODY, (False, False), params, carry, xs, None, dcarry, chunk=chunk)
    rdc, rdp, _ = sf.reverse_plain(T_BODY, (False, False), params, carry, xs,
                                   None, dcarry, chunk=chunk)
    assert dxd == []
    for a, b in zip(dc, rdc):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for k in rdp:
        torch.testing.assert_close(
            dp[k], rdp[k], rtol=1e-4,
            atol=1e-4 * max(float(rdp[k].abs().max()), 1e-6))


def _advance_against_step_loop(T, chunk, Bn, seed, token_steps):
    """The fused advance's chunk-entry boundaries and exit (h, c) are, bit
    for bit, the states of one run of the step loop (``token_steps``) over
    the whole segment from the same entry; two calls give the same bits,
    the loss accumulator and its boundaries included."""
    params, carry, (tok, tgt), _ = _segment(T, Bn, seed)
    adv = sf.fused_advance_segment
    before = (lc.lstm_cell.launches, adv.cell_launches, adv.cell_steps)
    outs = [adv(T_BODY, params, carry, (tok, tgt), None, chunk=chunk)
            for _ in range(2)]
    nc = len(sf.forward_bounds(T, chunk)) - 1   # one step loop a chunk
    assert (lc.lstm_cell.launches, adv.cell_launches, adv.cell_steps) == (
        before[0] + 2 * nc, before[1] + 2 * nc, before[2] + 2 * T)
    for out in outs:
        out.ready.synchronize()
    a, b = [list(o.carry) + list(o.boundaries) for o in outs]
    assert all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
    h0, c0, _ = carry
    hs = torch.empty((T + 1,) + tuple(h0.shape), device=h0.device)
    cs = torch.empty_like(hs)
    hs[0], cs[0] = h0, c0
    token_steps(tok, params["emb"], hs, cs, params["w"], params["b"])
    starts = sf.forward_bounds(T, chunk)[:-1]
    out = outs[0]
    assert torch.equal(out.boundaries[0], hs[starts].cpu())
    assert torch.equal(out.boundaries[1], cs[starts].cpu())
    assert torch.equal(out.carry[0], hs[T]) and torch.equal(out.carry[1],
                                                            cs[T])


@pytest.mark.parametrize("T,chunk,Bn", [
    (23, 5, 5),    # uneven chunk tail
    (21, 5, 3),    # a merged length-1 tail: a chunk of chunk + 1 steps
])
def test_fused_advance_equals_the_step_loop(card_paths, T, chunk, Bn):
    _advance_against_step_loop(
        T, chunk, Bn, seed=40 + T,
        token_steps=lambda tok, emb, hs, cs, w, b: lc._token_steps(
            tok, emb, hs, cs, w, b, None, None))


def test_offloaded_gradient_through_the_kernel_sources(card_paths):
    """The front-end's fused runner on the emulated kernels: the dense
    autograd loss and gradients, one launch of each segment kernel per
    segment and direction, and kernel 1's step-loop launches and steps by
    caller as ``segment_fused.cell_work`` counts them from the plan."""
    params, _, _, _ = _segment(1, 1, seed=9)
    tok = torch.tensor(np.random.default_rng(1).integers(0, V, (5, 30)),
                       dtype=torch.int32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = lstm.forward_loss(leaves, tok)
    dense = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    wrappers = {"advance": sf.fused_advance_segment,
                "reverse": sf.fused_reverse_segment}
    before = {k: (f.launches, f.cell_launches, f.cell_steps)
              for k, f in wrappers.items()}
    v, g = api.value_and_grad_offloaded(
        lstm.train_chain(), interval=13, slots=4, runner="fused",
        device="cpu")(params, {"tokens": tok})
    plan = api.last_plan()
    want = {k: [plan.num_segments, 0, 0] for k in wrappers}
    for seg in plan.segments:
        chunk = chunk_length(seg.length, plan.s_l1) or seg.length
        for k, (n, steps) in sf.cell_work(seg.length, chunk).items():
            want[k][1] += n
            want[k][2] += steps
    for k, f in wrappers.items():
        got = (f.launches, f.cell_launches, f.cell_steps)
        assert [a - b for a, b in zip(got, before[k])] == want[k], k
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for k in dense:
        torch.testing.assert_close(g[k], dense[k], rtol=1e-4,
                                   atol=1e-4 * float(dense[k].abs().max()))


def test_fused_advance_level2_entries_own_their_storage(card_paths,
                                                      monkeypatch):
    """Level 2 holds what it counts: every chunk entry of a fused advance
    is an allocation of its own, and each entry the executor stores (the
    kernel's ``entries[0]``, kept without a copy) has storage bytes equal to
    its ``tree_bytes`` — so the store's live bytes are the bytes held."""
    from repro_torch.api.chain import diff_mask
    from repro_torch.core import storage
    from repro_torch.core.compiled_ops import (CompiledChainOps,
                                               FusedSegmentRunner)
    from repro_torch.core.executor import CheckpointExecutor

    params, carry, xs, _ = _segment(31, 4, seed=12)
    out = sf.fused_advance_segment(T_BODY, params, carry, xs, None, chunk=4)
    assert len(out.entries) == len(sf.forward_bounds(31, 4)) - 1 == 8
    for entry in out.entries:
        held = sum(t.untyped_storage().nbytes() for t in entry)
        assert held == storage.tree_bytes(entry)
    handed = []
    real_views = storage._frozen_views

    def views(tree):
        handed.append(tree)
        return real_views(tree)

    monkeypatch.setattr(storage, "_frozen_views", views)
    runner = FusedSegmentRunner(CompiledChainOps(T_BODY, *diff_mask(xs)),
                                params, xs, None, s_l1=4)
    _, run = CheckpointExecutor().multistage_forward(
        carry, 31, interval=12, s_l1=4, runner=runner)
    run.engine.wait_stores()
    assert len(handed) == run.plan.num_segments == 3
    held = [sum(t.untyped_storage().nbytes() for t in tree)
            for tree in handed]
    assert held == [storage.tree_bytes(tree) for tree in handed]
    assert run.engine.backend.live_bytes == sum(held)
    for seg, tree in zip(run.plan.segments, handed):
        stored = run.engine.backend.get(seg.begin)
        assert all(np.shares_memory(a, t.numpy())
                   for a, t in zip(stored, tree))
    run.close()


def test_fused_advance_slice_handover_is_refused(card_paths):
    """The hand-over the Level-2 guard exists for: ``leaf[0]`` of a
    segment's stacked ``(nc, ...)`` boundary buffer would keep all ``nc``
    chunk entries alive; the store refuses it on the caller's thread."""
    from repro_torch.core.storage import (AsyncTransferEngine, HostTree,
                                          RAMStorage)

    params, carry, xs, _ = _segment(13, 3, seed=13)
    out = sf.fused_advance_segment(T_BODY, params, carry, xs, None, chunk=4)
    stacked = out.boundaries
    eng = AsyncTransferEngine(RAMStorage(), device="cpu")
    with pytest.raises(ValueError, match="own their storage"):
        eng.store_async(0, HostTree(tuple(leaf[0] for leaf in stacked)))
    eng.store_async(0, HostTree(out.entries[0]))   # the repaired hand-over
    eng.wait_stores()
    assert eng.backend.live_bytes == sum(
        t.untyped_storage().nbytes() for t in out.entries[0])
    eng.close()


@pytest.fixture
def cell_on_card(card_paths, monkeypatch):
    """``lstm_cell`` taking its card path on CPU tensors: one launch of the
    emulated single-step kernel."""
    def on_card(x, h, c, w, b):
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
        lc._launch("lstm_cell_f32", x, None, h, c, w, b, h_out, c_out, None,
                   None)
        return h_out, c_out

    on_card.launches = on_card.steps = 0
    monkeypatch.setattr(lc, "lstm_cell", on_card)
    return on_card


def test_lstm_cell_kernel_under_autograd(cell_on_card):
    """``lstm_cell_autograd``: the kernel forward (one launch), and as
    backward the vjp of the plain cell recomputed from the saved inputs (no
    launch); gradients of every input within 1e-5 of plain autograd through
    ``lstm_cell_ref``."""
    rng = np.random.default_rng(21)
    Bn, Dx, Dh = 9, 8, 20
    ins = [torch.tensor(a) for a in (
        _np(rng, (Bn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), 0.2), _np(rng, (4 * Dh,), 0.1))]
    gh, gc = (torch.tensor(_np(rng, (Bn, Dh))) for _ in range(2))

    def grads(cell):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        h, c = cell(*leaves)
        return (h, c), torch.autograd.grad(
            (h * gh).sum() + (c * gc).sum(), leaves)

    (h, c), g = grads(lc.lstm_cell_autograd)
    assert cell_on_card.launches == 1
    (hr, cr), gr = grads(lstm_cell_ref)
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, cr, rtol=1e-5, atol=1e-5)
    for a, b in zip(g, gr):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,forward_steps", [
    ({"strategy": "conventional"}, 19),
    ({"strategy": "revolve", "slots": 4}, 19),
    ({"engine": "interpreted", "interval": 7, "slots": 3}, 0),
])
def test_strategies_run_the_cell_kernel_once_a_step(cell_on_card, kw,
                                                    forward_steps):
    """Through the front door, every chain step of the per-step strategies
    runs the cell kernel once: the forward sweep that computes ``x_n`` (the
    baselines'; the multistage forward is the executor's own), each
    advance, and each backward's recompute.  Loss and gradients agree with
    dense autograd of the plain cell."""
    params, _, _, _ = _segment(1, 1, seed=14)
    tok = torch.tensor(np.random.default_rng(2).integers(0, V, (4, 20)),
                       dtype=torch.int32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = lstm.forward_loss(leaves, tok)
    dense = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    v, g = api.value_and_grad_offloaded(lstm.train_chain(), device="cpu",
                                        **kw)(params, {"tokens": tok})
    stats = api.last_stats()
    assert cell_on_card.launches == (forward_steps + stats.advances
                                     + stats.backwards)
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for k in dense:
        torch.testing.assert_close(g[k], dense[k], rtol=1e-4,
                                   atol=1e-4 * float(dense[k].abs().max()))


@pytest.mark.parametrize("B,Sq,Sk,H,G,D,dtype,kw", [
    # two query tiles with a ragged edge, a ragged last kv tile
    (1, 70, 70, 2, 1, 16, torch.float32, {}),
    # Sq < Sk, GQA, sliding window and softcap, bf16
    (1, 40, 75, 4, 2, 64, torch.bfloat16, {"window": 20, "softcap": 30.0}),
    # non-causal, a head dim that leaves lanes idle, two batch rows
    (2, 33, 33, 2, 2, 40, torch.float32, {"causal": False, "scale": 0.3}),
    # the tensor-core kernel at D=256 (32-key tiles): two query tiles, a
    # ragged query and kv edge, softcap
    (1, 70, 70, 2, 1, 256, torch.bfloat16, {"softcap": 50.0,
                                            "scale": 0.0625}),
    # D=128, Sq > Sk: rows that see no key give 0; non-causal GQA
    (1, 80, 50, 2, 1, 128, torch.bfloat16, {}),
    (1, 20, 150, 4, 1, 128, torch.bfloat16, {"causal": False}),
    # D=16 (gemma2-2b SMOKE's head dim): window and softcap, GQA; D=32
    (1, 70, 70, 4, 2, 16, torch.bfloat16, {"window": 8, "softcap": 50.0,
                                           "scale": 0.25}),
    (2, 33, 40, 2, 1, 32, torch.bfloat16, {"causal": False}),
])
def test_flash_attention_kernel_source(card_paths, B, Sq, Sk, H, G, D,
                                       dtype, kw):
    rng = np.random.default_rng(Sq + D)
    q, k, v = (torch.tensor(_np(rng, shape)).to(dtype) for shape in (
        (B, Sq, H, D), (B, Sk, G, D), (B, Sk, G, D)))
    before = fa.flash_attention.launches
    out, lse = fa._launch(q, k, v, kw.get("causal", True), kw.get("window"),
                          kw.get("softcap"), kw.get("scale"))
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention(q, k, v, **kw)   # the plain version (CPU)
    _, want_lse = _chunked_fwd(q, k, v, kw.get("causal", True),
                               kw.get("window"), kw.get("softcap"), 16,
                               kw.get("scale"))
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    seen = Sq - max(Sq - Sk, 0) if kw.get("causal", True) else Sq
    unseen = Sq - seen   # rows before the first key: 0 from the kernel
    assert not bool(out[:, :unseen].float().abs().gt(0).any())
    torch.testing.assert_close(out[:, unseen:].float(),
                               want[:, unseen:].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse[..., unseen:], want_lse[..., unseen:],
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_bf16_rejects_other_head_dims(card_paths):
    """The tensor-core kernel takes D in {16, 32, 64, 128, 256}; any other
    bf16 head dim is refused by the C entry point (and by the wrapper on the
    card), never routed elsewhere."""
    q = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa._launch(q, k, k, True, None, None, None)


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


# --- the fused reverse's kernels one by one (csrc/segment_fused.cu) -------


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("M,Ka,N,accumulate,slices", [
    (700, 70, 130, 0, 5),   # ragged 64 x 128 output tiles
    (300, 7, 10, 1, 2),     # accumulated onto C
    (300, 300, 20, 0, 2),   # 128-row tiles (8 x 8 a thread), ragged
    (40, 12, 17, 0, 1),
])
def test_grad_reduce_split_m(card_paths, M, Ka, N, accumulate, slices):
    """[A, 1]^T B over M rows, split into slices summed in a fixed order:
    the parameter-gradient reduction of the fused reverse."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(M + Ka)
    A = torch.tensor(_np(rng, (M, Ka)))
    Bm = torch.tensor(_np(rng, (M, N)))
    C0 = torch.tensor(_np(rng, (Ka + 1, N)))
    C = C0.clone()
    S = lib.grad_reduce_slices(Ka, N, M)
    assert S == slices
    part = torch.full((S * (Ka + 1) * N,), float("nan"))
    err = lib.grad_reduce(_ptr(A), Ka, _ptr(Bm), N, M, Ka, N, _ptr(C),
                          accumulate, _ptr(part), None)
    assert err == 0
    want = torch.cat([A, torch.ones(M, 1)], 1).double().t() @ Bm.double()
    if accumulate:
        want = want + C0.double()
    torch.testing.assert_close(C.double(), want, rtol=1e-5, atol=1e-4)
    # two calls give the same bits
    C2 = C0.clone()
    lib.grad_reduce(_ptr(A), Ka, _ptr(Bm), N, M, Ka, N, _ptr(C2),
                    accumulate, _ptr(part), None)
    assert torch.equal(C, C2)


@pytest.mark.parametrize("Bn,L,Dh_,V_", [
    (5, 7, 12, 17),
    (8, 8, 256, 17),   # the logits product split in two slices of Dh
    (40, 8, 12, 17),   # M = 320 rows: 128-row tiles, a ragged one
])
def test_reverse_hoisted_products(card_paths, Bn, L, Dh_, V_):
    """Logits, dlogits and dlogits w_out^T for all rows of a chunk at
    once, against plain PyTorch."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(8)
    M = L * Bn
    w_out = torch.tensor(_np(rng, (Dh_, V_), 0.3))
    b_out = torch.tensor(_np(rng, (V_,), 0.1))
    hs1 = torch.tensor(_np(rng, (M, Dh_)))
    tgt = torch.tensor(rng.integers(0, V_, M), dtype=torch.int32)
    dacc = torch.tensor(0.7)
    dl = torch.empty((M, V_))
    dh_extra = torch.empty((M, Dh_))
    part = torch.full((max(1, lib.lstm_rev_scratch(V_, 8, Dh_, M)),),
                      float("nan"))
    assert lib.lstm_rev_hoisted(_ptr(w_out), _ptr(b_out), V_, Dh_, _ptr(tgt),
                                _ptr(hs1), _ptr(dacc), _ptr(dl),
                                _ptr(dh_extra), M, Bn, _ptr(part), None) == 0
    g = 0.7 / Bn
    want = g * (torch.softmax(hs1 @ w_out + b_out, 1)
                - torch.nn.functional.one_hot(tgt.long(), V_))
    torch.testing.assert_close(dl, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dh_extra, want @ w_out.t(), rtol=1e-5,
                               atol=1e-6)


def _cell(z, c):
    i, f, o, g = z.chunk(4, 1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


@pytest.mark.parametrize("Bn,Dh_,L", [(20, 40, 3), (3, 12, 1), (70, 40, 2)])
def test_reverse_walk(card_paths, Bn, Dh_, L):
    """The walk: one launch per step carrying dh_t = dz_t W_h^T, with the
    cell's vjp in its epilogue, against autograd of the cell step by step
    (ragged row and unit tiles at B=20, Dh=40; at B=70 the emulated card's
    4 resident blocks hold 2 column tiles by 2 of the 5 row tiles, so a
    block loops over its row tiles within a step)."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(Bn)
    Dx_ = 8
    N4 = 4 * Dh_
    w = torch.tensor(_np(rng, (Dx_ + Dh_, N4), 0.2))
    z = torch.tensor(_np(rng, (L, Bn, N4)))
    cs = [torch.tensor(_np(rng, (Bn, Dh_), 0.5))]
    acts = []
    for t in range(L):
        i, f, o, g = z[t].chunk(4, 1)
        acts.append(torch.cat([torch.sigmoid(i), torch.sigmoid(f + 1.0),
                               torch.sigmoid(o), torch.tanh(g)], 1))
        cs.append(_cell(z[t], cs[t])[1].detach())
    cs_t, acts_t = torch.stack(cs).contiguous(), torch.stack(acts)
    dh_extra = torch.tensor(_np(rng, (L, Bn, Dh_), 0.1))
    dh0 = torch.tensor(_np(rng, (Bn, Dh_), 0.1))
    dc0 = torch.tensor(_np(rng, (Bn, Dh_), 0.1))
    dh, dc = dh0.clone(), dc0.clone()
    dz = torch.empty((L, Bn, N4))
    bar = torch.zeros(1, dtype=torch.int32)
    assert lib.lstm_rev_walk(_ptr(w), Dx_, Dh_, _ptr(cs_t), _ptr(acts_t),
                             _ptr(dh_extra), _ptr(dh), _ptr(dc), _ptr(dz),
                             L, Bn, _ptr(bar), None) == 0
    rdh, rdc = dh0, dc0
    for t in range(L - 1, -1, -1):
        zt = z[t].clone().requires_grad_(True)
        ct = cs[t].clone().requires_grad_(True)
        dzt, rdc = torch.autograd.grad(_cell(zt, ct), (zt, ct),
                                       (rdh + dh_extra[t], rdc))
        torch.testing.assert_close(dz[t], dzt, rtol=1e-5, atol=1e-6)
        rdh = dzt @ w[Dx_:].t()
    torch.testing.assert_close(dh, rdh, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dc, rdc, rtol=1e-5, atol=1e-6)


def test_fused_reverse_refuses_a_hidden_width_the_walk_cannot_hold(
        card_paths):
    """The walk keeps 32 rows of W_h per block in shared memory: at the
    H100's 227 KB a block, Dh up to 280 fits, and a wider LSTM is refused
    with the limit named before any launch."""
    assert sf._seg_lib().lstm_rev_walk_max_dh() == 280
    Dh_, Bn = 288, 2
    params = {"emb": torch.zeros(V, 4), "w": torch.zeros(4 + Dh_, 4 * Dh_),
              "b": torch.zeros(4 * Dh_), "w_out": torch.zeros(Dh_, V),
              "b_out": torch.zeros(V)}
    carry = (torch.zeros(Bn, Dh_), torch.zeros(Bn, Dh_), torch.zeros(()))
    xs = (torch.zeros((3, Bn), dtype=torch.int32),) * 2
    with pytest.raises(ValueError, match="hidden width 288 is above 280"):
        sf.fused_reverse_segment(T_BODY, (False, False), params, carry, xs,
                                 None, carry, chunk=2)


@pytest.mark.parametrize("M,accumulate", [(600, 1), (100, 0)])
def test_embed_grad_split_m(card_paths, M, accumulate):
    """demb from dx by token id, M split into slices (two at M=600) added
    in order."""
    lib = sf._seg_lib()
    rng = np.random.default_rng(M)
    V_, Dx_ = 11, 8
    tok = torch.tensor(rng.integers(0, V_, M), dtype=torch.int32)
    dx = torch.tensor(_np(rng, (M, Dx_)))
    d0 = torch.tensor(_np(rng, (V_, Dx_)))
    demb = d0.clone()
    part = torch.full((max(1, lib.lstm_rev_scratch(V_, Dx_, 4, M)),),
                      float("nan"))
    assert lib.embed_grad(_ptr(tok), _ptr(dx), M, V_, Dx_, _ptr(demb),
                          accumulate, _ptr(part), None) == 0
    want = torch.zeros(V_, Dx_, dtype=torch.float64).index_add_(
        0, tok.long(), dx.double())
    if accumulate:
        want += d0.double()
    torch.testing.assert_close(demb.double(), want, rtol=1e-5, atol=1e-5)
