# Port of repro/configs/shapes.py: make_batch for every family's train
# shape.
"""Concrete input batches per (architecture x shape) cell.

``make_batch`` draws from the same ``numpy.random.default_rng(seed)``
stream, in the same leaf order, as the JAX package's, so both packages
train on identical batches.  Layouts (``train``):

* LM (lstm, dense, moe, hybrid, ssm): ``{"tokens": (B, S+1) int32}``;
* VLM: ``{"patch_embeds": (B, P, d) bf16, "tokens": (B, S-P+1) int32}``;
* encoder-decoder: ``{"frames": (B, max(2, S//2), d) bf16,
  "tokens": (B, dec_len+1) int32}``.

The JAX package fills its input specs leaf by leaf in sorted key order, so
the float leaves (``frames``, ``patch_embeds``: ``standard_normal * 0.02``
cast to bf16) are drawn before the tokens."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device

_LM_FAMILIES = ("lstm", "dense", "moe", "hybrid", "ssm")


def _train_layout(cfg: ArchConfig, shape: ShapeSpec):
    """``{name: (shape, is_float)}`` of the train inputs, in the JAX
    package's (sorted-key) drawing order."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    if cfg.family in _LM_FAMILIES:
        return {"tokens": ((B, S + 1), False)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        return {"patch_embeds": ((B, P, d), True),
                "tokens": ((B, S - P + 1), False)}
    if cfg.family == "encdec":
        return {"frames": ((B, max(2, S // 2), d), True),
                "tokens": ((B, cfg.dec_len + 1), False)}
    raise ValueError((cfg.family, shape.kind))


def make_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Deterministic batch for ``cfg`` at ``shape`` on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if shape.kind != "train":
        raise NotImplementedError(
            f"make_batch covers the train shapes only (got "
            f"kind={shape.kind!r}); prefill and decode inputs come with "
            "serving (ROADMAP queue 1, item 14)")
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, is_float) in _train_layout(cfg, shape).items():
        if is_float:
            a = rng.standard_normal(shp) * 0.02
            out[name] = torch.as_tensor(a.astype(np.float32),
                                        device=dev).to(torch.bfloat16)
        else:
            a = rng.integers(0, min(cfg.vocab, 1 << 30), size=shp)
            out[name] = torch.as_tensor(a.astype(np.int32), device=dev)
    return out
