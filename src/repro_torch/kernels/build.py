"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).
Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a digest of
their sources and flags, so a changed source is rebuilt and an unchanged
one is loaded as it is.  Nothing is built when a module is imported: the
first launch builds what it needs, and :func:`build_all` builds every
library at once, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# library name -> its translation unit; every header in csrc/ is shared
SOURCES = {
    "lstm_cell": "lstm_cell.cu",
    "segment_fused": "segment_fused.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
    "segment_generic": "segment_generic.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "rmsnorm": "rmsnorm.cu",
    "glu": "glu.cu",
    "rope": "rope.cu",
    "ssd_scan_bwd": "ssd_scan_bwd.cu",
    "gated_norm": "gated_norm.cu",
    "causal_conv": "causal_conv.cu",
    "dt_softplus": "dt_softplus.cu",
    "dense": "dense.cu",
    "moe": "moe.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # name -> nvcc/ptxas output of the last build


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built on the machine with the "
            "card")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named libraries (default: all) that are not built yet, one
    ``nvcc`` per source, started together.  Returns the seconds each build
    took (0.0 for a library that was already there); raises with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc for {name} exited {proc.returncode}:\n"
                          f"{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C entry points return
    ``cudaGetLastError()`` right after their launches)."""
    if err != 0:
        msg = lib.repro_error_string(int(err)).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def on_card(t) -> bool:
    """Whether a wrapper launches its kernel for ``t``: a CUDA tensor.  Any
    other tensor (the CPU's, or the byte profile's meta tensors) takes the
    kernel's plain version."""
    return t.is_cuda


def rows(t, width: int, what: str = "a kernel"):
    """``t`` as a (rows, ``width``) view with unit column stride (a column
    slice of wider rows is one) and its row stride, for a kernel that reads
    rows in place.  ``ValueError`` where no such view exists: the wrappers
    never copy an operand to fit a kernel."""
    try:
        r = t.view(-1, width)
    except RuntimeError:
        r = None
    if r is None or r.stride(1) != 1 or (r.shape[0] > 1
                                          and r.stride(0) < width):
        raise ValueError(f"{what}: an operand of shape {tuple(t.shape)} and "
                         f"strides {t.stride()} is not rows of {width} "
                         "values with one row stride")
    return r, r.stride(0)


def cotangent(g):
    """An autograd function's incoming cotangent as its backward kernels
    read it: ``g`` itself, or a dense copy where autograd hands back a view
    (a ``sum``'s broadcast, a concatenation's slice) -- the one copy the
    card's autograd functions make, which the decoders' chain bodies never
    need (their cotangents are dense: ``tools/profile_fused.py
    --body-only``)."""
    if g is not None and not g.is_contiguous():
        return g.contiguous()
    return g


def dense(t, what: str = "a kernel"):
    """``t`` itself when it is contiguous; ``ValueError`` otherwise (the
    wrappers never copy an operand to fit a kernel)."""
    if t is not None and not t.is_contiguous():
        raise ValueError(f"{what}: the operand of shape {tuple(t.shape)} "
                         f"and strides {t.stride()} must be contiguous")
    return t


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer for a ``c_void_p`` argument (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device=None) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
