"""The gated activation ``act(gate) * up`` (GeGLU with the tanh-approximate
GELU, SwiGLU with SiLU), forward and backward (``csrc/glu.cu``).

Replaces the arithmetic of ``repro/models/layers.py::geglu``/``swiglu``
and their vjps inside the TPU kernels ``repro/kernels/segment_pallas.py``'s
segments (a decoder body traced into the ``pallas_call``).  :func:`glu_act`
is what the model calls: on CUDA tensors an autograd function whose
forward and backward launch :func:`glu` and :func:`glu_bwd` (or raise), on
any other tensor the plain version :func:`glu_plain` (PyTorch's ``silu`` or
``gelu`` times ``up``, the JAX package's operations) under autograd, whose
vjp is :func:`glu_bwd_plain`.  The kernels compute in fp32 and round once;
the plain version rounds the activation and the product apart in bf16.
Launches count into ``glu.launches`` and ``glu_bwd.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
DTYPES = (torch.float32, torch.bfloat16)
ACTS = ("gelu", "silu")


def _lib():
    lib = build.load("glu")
    lib.glu_fwd.restype = _I
    lib.glu_fwd.argtypes = [_P] * 3 + [_L, _I, _I, _P]
    lib.glu_bwd.restype = _I
    lib.glu_bwd.argtypes = [_P] * 5 + [_L, _I, _I, _P]
    return lib


def _check(what, act, named) -> None:
    if act not in ACTS:
        raise ValueError(f"{what}: act {act!r} is not one of {ACTS}")
    ref = named[0][1]
    for name, t in named:
        if t.shape != ref.shape or t.dtype != ref.dtype \
                or t.device != ref.device:
            raise ValueError(f"{what}: {name}{tuple(t.shape)} {t.dtype} on "
                             f"{t.device} differs from {named[0][0]}"
                             f"{tuple(ref.shape)} {ref.dtype} on "
                             f"{ref.device}")
    if ref.dtype not in DTYPES:
        raise ValueError(f"{what}: dtype {ref.dtype} is not one of "
                         f"{list(DTYPES)}")


def glu_plain(gate: torch.Tensor, up: torch.Tensor, act: str
              ) -> torch.Tensor:
    a = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return a * up


def glu_bwd_plain(g: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                  act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dgate, dup) = (g up act'(gate), g act(gate))``: the vjp of
    :func:`glu_plain` by autograd over it recomputed, in the inputs'
    dtypes."""
    with torch.enable_grad():
        gr = gate.detach().requires_grad_(True)
        ur = up.detach().requires_grad_(True)
        return torch.autograd.grad(glu_plain(gr, ur, act), (gr, ur), g)


def glu(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """The forward kernel (CUDA tensors only): ``act(gate) * up``."""
    if not build.on_card(gate):
        raise ValueError("glu runs on the card only")
    _check("glu", act, [("gate", gate), ("up", up)])
    gate, up = build.dense(gate, "glu: gate"), build.dense(up, "glu: up")
    out = torch.empty_like(gate)
    lib = _lib()
    err = lib.glu_fwd(build.ptr(gate), build.ptr(up), build.ptr(out),
                      gate.numel(), ACTS.index(act),
                      int(gate.dtype == torch.bfloat16),
                      build.stream_ptr(gate.device))
    build.check(lib, err, "glu")
    glu.launches += 1
    return out


def glu_bwd(g: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel (CUDA tensors only): ``(dgate, dup)``."""
    if not build.on_card(gate):
        raise ValueError("glu_bwd runs on the card only")
    _check("glu_bwd", act, [("gate", gate), ("up", up), ("g", g)])
    g = build.dense(g, "glu_bwd: g")
    gate, up = build.dense(gate, "glu_bwd: gate"), build.dense(up, "up")
    dgate, dup = torch.empty_like(gate), torch.empty_like(up)
    lib = _lib()
    err = lib.glu_bwd(build.ptr(g), build.ptr(gate), build.ptr(up),
                      build.ptr(dgate), build.ptr(dup), gate.numel(),
                      ACTS.index(act), int(gate.dtype == torch.bfloat16),
                      build.stream_ptr(gate.device))
    build.check(lib, err, "glu_bwd")
    glu_bwd.launches += 1
    return dgate, dup


class _GLU(torch.autograd.Function):
    """The kernels as one autograd function (CUDA tensors)."""

    @staticmethod
    def forward(ctx, gate, up, act):
        ctx.save_for_backward(gate, up)
        ctx.act = act
        return glu(gate, up, act)

    @staticmethod
    def backward(ctx, g):
        gate, up = ctx.saved_tensors
        dgate, dup = glu_bwd(build.cotangent(g), gate, up, ctx.act)
        return dgate, dup, None


def glu_act(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """``act(gate) * up``, ``act`` ``"gelu"`` (tanh-approximate) or
    ``"silu"``; differentiable in both: the kernels on the card, autograd
    over the plain version elsewhere."""
    if build.on_card(gate):
        return _GLU.apply(gate, up, act)
    return glu_plain(gate, up, act)


glu.launches = 0
glu_bwd.launches = 0
