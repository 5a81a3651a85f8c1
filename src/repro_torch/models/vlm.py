# Port of repro/models/vlm.py: init_vlm and train_loss.
"""VLM backbone (InternVL2-family): the decoder with prepended patch
embeddings.

The vision tower is a stub, as in the JAX package: the batch supplies
precomputed patch embeddings ``(B, n_patches, d_model)``; a learned
projection maps them into the text embedding space (the real model's MLP
projector), then the decoder stack of :mod:`repro_torch.models.transformer`
runs over ``[patches | text]`` with the loss on the text positions only.
At ``n_patches + text > 2048`` its attention takes the chunked path (the
flash kernel on the card).  ``prefill`` and ``decode`` come with serving
(ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (chunked_ce_loss, dense, embed,
                                       init_dense, rmsnorm, rope_table)

Params = Any


def init_vlm(generator: torch.Generator, cfg: ArchConfig, *,
             device=None) -> Params:
    """``init_lm``'s parameters plus the patch projection ``patch_proj``
    (``d_model -> d_model``)."""
    params = tf.init_lm(generator, cfg, device=device)
    params["patch_proj"] = init_dense(generator, cfg.d_model, cfg.d_model,
                                      device=resolve_device(device))
    return params


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig) -> torch.Tensor:
    """batch: tokens (B, S_text+1) int32, patch_embeds (B, P, d_model)."""
    dt = tf._dtypes(cfg)
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    S_text = inp.shape[1]
    patches = dense(params["patch_proj"],
                    batch["patch_embeds"].to(dt.compute), dt)
    text = embed(params["embed"], inp, dt)
    h = torch.cat([patches, text], dim=1)
    rope = rope_table(h.shape[1], cfg.hd, cfg.rope_theta, device=h.device)
    h, _ = tf._scan_stack(params, h, cfg, rope, dt)
    h = rmsnorm(params["final_norm"], h, dt=dt)
    return chunked_ce_loss(h[:, -S_text:], tf.unembed_weight(params, cfg),
                           labels, chunk=cfg.ce_chunk,
                           logit_cap=cfg.logit_softcap,
                           valid_vocab=cfg.vocab)
