# Port of repro/models/moe.py: the dense gated MLP only.
"""Feed-forward layers: the dense gated MLP (SwiGLU or GeGLU).

The routed Mixture-of-Experts (``init_moe``/``moe_apply``, both dispatch
implementations and the routing statistics) comes with the MoE family
(ROADMAP queue 1, item 10).  ``distributed.sharding.constrain`` is the
identity on one device and is dropped.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.layers import (DEFAULT_DTYPES, DTypes, dense, geglu,
                                       init_dense, swiglu)

Params = Any


def init_mlp(generator, d_model: int, d_ff: int, *, dtype=torch.float32,
             lead: Tuple[int, ...] = (), device=None) -> Params:
    def dn(d_in, d_out):
        return init_dense(generator, d_in, d_out, dtype=dtype, lead=lead,
                          device=device)

    return {"gate": dn(d_model, d_ff), "up": dn(d_model, d_ff),
            "down": dn(d_ff, d_model)}


def mlp(p: Params, x: torch.Tensor, *, act: str = "silu",
        dt: DTypes = DEFAULT_DTYPES) -> torch.Tensor:
    g, u = dense(p["gate"], x, dt), dense(p["up"], x, dt)
    h = swiglu(g, u) if act == "silu" else geglu(g, u)
    return dense(p["down"], h, dt)
