# Port of repro/configs/shapes.py: make_batch for the lstm, dense and ssm
# families' train shapes.
"""Concrete input batches per (architecture x shape) cell.

``make_batch`` draws from the same ``numpy.random.default_rng(seed)``
stream as the JAX package's, so both packages train on identical tokens.
Layout (``train``): ``{"tokens": (B, S+1) int32}``."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device


def make_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Deterministic batch for ``cfg`` at ``shape`` on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if cfg.family not in ("lstm", "dense", "ssm") or shape.kind != "train":
        raise NotImplementedError(
            f"make_batch covers the lstm, dense and ssm families' train "
            f"shapes only "
            f"(got family={cfg.family!r}, kind={shape.kind!r}); other "
            "families come with their models (ROADMAP queue 1, item 10)")
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    tokens = rng.integers(0, min(cfg.vocab, 1 << 30), size=(B, S + 1))
    return {"tokens": torch.as_tensor(tokens.astype(np.int32), device=dev)}
