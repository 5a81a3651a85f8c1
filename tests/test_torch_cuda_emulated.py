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

    return re.sub(r"([\w:]+(?:<[\w:]+>)?)<<<(.*?)>>>\((.*?)\);", launch,
                  source, flags=re.S)


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    libs = {}
    for name, src in build.SOURCES.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(_to_cpp((build.CSRC / src).read_text()))
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
        libs[name] = lib
    return libs


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

    def tokens(tok, emb, h, c, w, b, *, h_out, c_out, xh_out=None,
               acts_out=None):
        lc._launch("lstm_cell_f32", emb, tok, h, c, w, b, h_out, c_out,
                   xh_out, acts_out)

    monkeypatch.setattr(lc, "lstm_cell_tokens", tokens)


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


def test_lstm_cell_gather_variant_writes_its_side_outputs(card_paths):
    rng = np.random.default_rng(3)
    Bn, Dx, Dh, Vn = 9, 8, 36, 11
    emb, h, c, w, b = [torch.tensor(a) for a in (
        _np(rng, (Vn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), 0.1), _np(rng, (4 * Dh,), 0.1))]
    tok = torch.tensor(rng.integers(0, Vn, Bn), dtype=torch.int32)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    xh, acts = torch.full((Bn, Dx + Dh), -7.0), torch.full((Bn, 4 * Dh), -7.0)
    lc.lstm_cell_tokens(tok, emb, h, c, w, b, h_out=h_out, c_out=c_out,
                        xh_out=xh, acts_out=acts)
    x = emb[tok.long()]
    hr, cr = lstm_cell_ref(x, h, c, w, b)
    torch.testing.assert_close(h_out, hr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c_out, cr, rtol=1e-5, atol=1e-5)
    assert torch.equal(xh, torch.cat([x, h], 1))
    i, f, o, g = (torch.cat([x, h], 1) @ w + b).chunk(4, 1)
    torch.testing.assert_close(
        acts, torch.cat([torch.sigmoid(i), torch.sigmoid(f + 1),
                         torch.sigmoid(o), torch.tanh(g)], 1),
        rtol=1e-5, atol=1e-5)


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


def test_offloaded_gradient_through_the_kernel_sources(card_paths):
    """The front-end's fused runner on the emulated kernels: the dense
    autograd loss and gradients, and one launch of each segment kernel per
    segment and direction."""
    params, _, _, _ = _segment(1, 1, seed=9)
    tok = torch.tensor(np.random.default_rng(1).integers(0, V, (5, 30)),
                       dtype=torch.int32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = lstm.forward_loss(leaves, tok)
    dense = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    before = (sf.fused_advance_segment.launches,
              sf.fused_reverse_segment.launches)
    v, g = api.value_and_grad_offloaded(
        lstm.train_chain(), interval=13, slots=4, runner="fused",
        device="cpu")(params, {"tokens": tok})
    segs = api.last_plan().num_segments
    assert (sf.fused_advance_segment.launches - before[0],
            sf.fused_reverse_segment.launches - before[1]) == (segs, segs)
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
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,T,H,G,P,N,chunk,dtype,with_h0", [
    (1, 40, 2, 1, 8, 8, 16, torch.float32, True),    # ragged last chunk
    (2, 32, 4, 2, 16, 12, 8, torch.bfloat16, False),  # groups, bf16
])
def test_ssd_scan_kernel_source(card_paths, B, T, H, G, P, N, chunk, dtype,
                                with_h0):
    rng = np.random.default_rng(T + P)
    x = torch.tensor(_np(rng, (B, T, H, P), 0.5)).to(dtype)
    dt = torch.nn.functional.softplus(torch.tensor(_np(rng, (B, T, H))))
    A = -torch.exp(torch.tensor(_np(rng, (H,), 0.3)))
    b = torch.tensor(_np(rng, (B, T, G, N), 0.5)).to(dtype)
    c = torch.tensor(_np(rng, (B, T, G, N), 0.5)).to(dtype)
    h0 = torch.tensor(_np(rng, (B, H, P, N), 0.5)) if with_h0 else None
    before = ssd.ssd_scan.launches
    y, h = ssd._launch(x, dt, A, b, c, h0, chunk)
    assert ssd.ssd_scan.launches == before + 1
    y_ref, h_ref = ssd.ssd_scan(x, dt, A, b, c, chunk=chunk, h0=h0)  # plain
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)
