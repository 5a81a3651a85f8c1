"""The harness of the emulated-kernel tests (``test_torch_cuda_emulated*``):
the CUDA sources under ``src/repro_torch/kernels/csrc`` rewritten only where
the C++ compiler cannot read CUDA (``kernel<<<grid, block, ...>>>(args)``
becomes a call of the emulator's launcher) and compiled with ``g++``
against the CPU stand-in headers of ``tests/cuda_emu/`` (every CUDA thread
a host thread), loaded in place of the ``nvcc``-built libraries, with the
CUDA-only pieces of PyTorch (page-locked memory, streams, events, graph
capture) stubbed, so the wrappers' card paths run on CPU tensors."""
import ctypes
import pathlib
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.convert import init_lstm_numpy, params_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import segment_fused as sf
from repro_torch.models import lstm

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


class _Libs(dict):
    """The emulated libraries, each compiled at its first use."""

    def __init__(self, out: pathlib.Path):
        super().__init__()
        self.out = out

    def __missing__(self, name):
        lib = self[name] = _compile(
            (build.CSRC / build.SOURCES[name]).read_text(), self.out, name)
        return lib

    def prebuild(self, names):
        """Compile the named libraries not built yet, all at once."""
        from concurrent.futures import ThreadPoolExecutor

        todo = [n for n in names if n not in self]
        with ThreadPoolExecutor(max(1, len(todo))) as pool:
            for name, lib in zip(todo, pool.map(
                    lambda n: _compile((build.CSRC / build.SOURCES[n])
                                       .read_text(), self.out, n), todo)):
                self[name] = lib


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    return _Libs(tmp_path_factory.mktemp("cuda_emu"))


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


class _EagerGraph:
    """A captured segment's graph under the emulation: each replay runs the
    launches again (they read the argument block, as the graph's do); like
    a graph's replay it adds nothing to the launch counters (the captured
    run adds the launches the graph holds itself)."""

    def __init__(self, launch):
        self.launch = launch

    def replay(self):
        counts = (lc.lstm_cell.launches, lc.lstm_cell.steps)
        self.launch()
        lc.lstm_cell.launches, lc.lstm_cell.steps = counts


def _eager_capture(launch):
    """``segment_fused._capture`` under the emulation: the warm-up run that
    precedes a capture on the card, whose launches stand for the ones a
    capture would record (the counters are left as they were)."""
    counts = (lc.lstm_cell.launches, lc.lstm_cell.steps)
    launch()
    held = (lc.lstm_cell.launches - counts[0], lc.lstm_cell.steps - counts[1])
    lc.lstm_cell.launches, lc.lstm_cell.steps = counts
    return _EagerGraph(launch), held


@pytest.fixture
def card_paths(emulated_libs, monkeypatch):
    """Route the wrappers' CUDA paths to the emulated kernels (a captured
    segment's graph replays its launches)."""
    monkeypatch.setattr(sf, "_capture", _eager_capture)
    monkeypatch.setattr(build, "load", lambda name: emulated_libs[name])
    monkeypatch.setattr(build, "stream_ptr",
                        lambda device=None: ctypes.c_void_p(0))
    monkeypatch.setattr(sf, "torch", _TorchOnHost())
    monkeypatch.setattr(sf, "_on_cpu", lambda tree: False)
    monkeypatch.setattr(lc, "lstm_cell_token_steps",
                        lambda tok, emb, hs, cs, w, b, *, xh=None,
                        acts=None, barrier=None, entry=None, **kw:
                        lc._token_steps(tok, emb, hs, cs, w, b, xh, acts,
                                        barrier, entry, **kw))


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


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


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


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


@pytest.fixture
def kernels_on_card(emulated_libs, monkeypatch):
    """The model kernels' wrappers (``build.on_card``: flash attention, its
    backward, rmsnorm, glu, rope, the projections' GEMM, the SSD scan and
    its backward, the causal conv, the step sizes, the gated norm, the LSTM
    cell) take their card
    paths on CPU tensors, with the emulated kernels; meta tensors keep the
    plain versions."""
    monkeypatch.setattr(build, "load", lambda name: emulated_libs[name])
    monkeypatch.setattr(build, "stream_ptr",
                        lambda device=None: ctypes.c_void_p(0))
    monkeypatch.setattr(build, "on_card", lambda t: t.device.type == "cpu")


def bits_equal(a, b) -> bool:
    """Same shape, dtype and bits (bf16 compared as int16)."""
    def bits(t):
        t = t.detach().contiguous()
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(bits(a), bits(b))


def scaled_err(a, b) -> float:
    """max |a - b| over max |b| (1e-30 at least), in fp32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def token_axis_ops(run, B: int, S: int):
    """The ATen operators ``run()`` dispatches, other than allocations
    (``empty*``) and views, whose output runs over the tokens (leading
    ``(B, S)`` or ``B S`` rows): ``[(operator, shape), ...]``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    found = []

    def token(shape):
        return len(shape) >= 1 and (tuple(shape[:2]) == (B, S)
                                    or shape[0] == B * S)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            if not view and not func.overloadpacket.__name__.startswith(
                    "empty"):
                for t in pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor) and token(t.shape):
                        found.append((str(func), tuple(t.shape)))
            return out

    with Count():
        run()
    return found


def body_step_ops(arch: str, n_layers: int, B: int, S: int, monkeypatch):
    """:func:`token_axis_ops` of one chain step of ``arch``'s SMOKE decoder
    (``train_chain``'s body over its first period, in the model's own
    compute dtype) and of the step's vjp, with the kernels' card paths on
    the CPU (the caller holds ``kernels_on_card``); attention takes its
    chunked (flash) path at this length, as it does on the card at
    S=4096."""
    import functools

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.configs.shapes import make_batch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.model_factory import get_model

    attention = attn_mod.attention

    @functools.wraps(attention)
    def chunked(*args, **kw):
        return attention(*args, **{**kw, "use_chunked": True})

    monkeypatch.setattr(attn_mod, "attention", chunked)
    cfg = get_config(arch, smoke=True).replace(n_layers=n_layers)
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    batch = make_batch(cfg, ShapeSpec("t", S, B, "train"), 0, device="cpu")
    spec = tf.train_chain(cfg)
    with torch.no_grad():
        carry, xs = spec.prelude(params, batch)
    lp = pytree.tree_map(lambda t: t[0].detach().requires_grad_(True), xs)
    carry = pytree.tree_map(lambda t: t.detach().requires_grad_(True), carry)
    ins = pytree.tree_leaves(carry) + [t for t in pytree.tree_leaves(lp)
                                       if t.is_floating_point()]
    with torch.no_grad():
        cots = [torch.ones_like(t) for t in pytree.tree_leaves(carry)]

    def run():
        out = pytree.tree_leaves(spec.body(params, carry, lp, batch))
        torch.autograd.grad(out, ins, cots, allow_unused=True)

    return token_axis_ops(run, B, S)
