# Port of repro/models/encdec.py: init_encdec, encode, _dec_layer_seq and
# train_loss.
"""Encoder-decoder backbone (Whisper-family).

The audio frontend (log-mel + conv downsampling) is a stub, as in the JAX
package: the batch supplies precomputed frame embeddings
``(B, S_enc, d_model)``.  Norms and positions follow the RMSNorm + RoPE
substrate of the decoders; the layer, head and feed-forward widths follow
the published config.

Encoder: non-causal self-attention blocks (the flash kernel on the card
when the encoder is longer than 2048 frames).  Decoder: causal
self-attention, cross-attention to the encoder output, MLP.

``remat_layer`` (the JAX package's per-layer remat policy) is not applied:
the port's decoders leave it out as well (ROADMAP queue 3).  Caches,
``prefill`` and ``decode`` come with serving (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (DTypes, chunked_ce_loss, embed,
                                       init_embedding, init_rmsnorm, rmsnorm,
                                       rope_table)
from repro_torch.models.transformer import _periods

Params = Any


def _dtypes(cfg: ArchConfig) -> DTypes:
    return DTypes(compute=torch.bfloat16)


def _init_enc_layers(generator, cfg: ArchConfig, device) -> Params:
    lead, d = (cfg.n_enc_layers,), cfg.d_model
    return {
        "ln1": init_rmsnorm(d, lead=lead, device=device),
        "attn": attn_mod.init_attention(generator, d, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, lead=lead,
                                        device=device),
        "ln2": init_rmsnorm(d, lead=lead, device=device),
        "mlp": moe_mod.init_mlp(generator, d, cfg.d_ff, lead=lead,
                                device=device),
    }


def _init_dec_layers(generator, cfg: ArchConfig, device) -> Params:
    lead, d = (cfg.n_layers,), cfg.d_model
    return {
        "ln1": init_rmsnorm(d, lead=lead, device=device),
        "attn": attn_mod.init_attention(generator, d, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, lead=lead,
                                        device=device),
        "ln_x": init_rmsnorm(d, lead=lead, device=device),
        "xattn": attn_mod.init_attention(generator, d, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.hd, lead=lead,
                                         device=device),
        "ln2": init_rmsnorm(d, lead=lead, device=device),
        "mlp": moe_mod.init_mlp(generator, d, cfg.d_ff, lead=lead,
                                device=device),
    }


def init_encdec(generator: torch.Generator, cfg: ArchConfig, *,
                device=None) -> Params:
    """Random parameters with ``init_encdec``'s keys, layouts and
    distributions (layers stacked over the leading axis), drawn from
    ``generator`` and placed on ``device`` (the card unless
    ``device="cpu"``).  The draws differ from the JAX package's."""
    dev = resolve_device(device)
    return {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model,
                                device=dev),
        "enc_layers": _init_enc_layers(generator, cfg, dev),
        "dec_layers": _init_dec_layers(generator, cfg, dev),
        "enc_norm": init_rmsnorm(cfg.d_model, device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, device=dev),
    }


def encode(params: Params, frames: torch.Tensor, cfg: ArchConfig):
    """frames: (B, S_enc, d_model) — precomputed frame embeddings (stub)."""
    dt = _dtypes(cfg)
    x = frames.to(dt.compute)
    rope = rope_table(frames.shape[1], cfg.hd, cfg.rope_theta,
                      device=x.device)
    for lp in _periods(params["enc_layers"]):
        y = rmsnorm(lp["ln1"], x, dt=dt)
        y = attn_mod.attention(lp["attn"], y, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                               rope=rope, causal=False, chunk=cfg.attn_chunk,
                               dt=dt)
        x = x + y
        y = moe_mod.mlp(lp["mlp"], rmsnorm(lp["ln2"], x, dt=dt),
                        act=cfg.mlp_act, dt=dt)
        x = x + y
    return rmsnorm(params["enc_norm"], x, dt=dt)


def _dec_layer_seq(lp, x, enc, rope, cfg: ArchConfig, dt):
    y = rmsnorm(lp["ln1"], x, dt=dt)
    y = attn_mod.attention(lp["attn"], y, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                           rope=rope, causal=True, chunk=cfg.attn_chunk,
                           dt=dt)
    x = x + y
    y = attn_mod.cross_attention(lp["xattn"], rmsnorm(lp["ln_x"], x, dt=dt),
                                 enc, n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                                 dt=dt)
    x = x + y
    y = moe_mod.mlp(lp["mlp"], rmsnorm(lp["ln2"], x, dt=dt),
                    act=cfg.mlp_act, dt=dt)
    return x + y


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig) -> torch.Tensor:
    """batch: frames (B, S_enc, d), tokens (B, S_dec+1)."""
    dt = _dtypes(cfg)
    enc = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    x = embed(params["embed"], inp, dt)
    rope = rope_table(inp.shape[1], cfg.hd, cfg.rope_theta, device=x.device)
    for lp in _periods(params["dec_layers"]):
        x = _dec_layer_seq(lp, x, enc, rope, cfg, dt)
    x = rmsnorm(params["final_norm"], x, dt=dt)
    return chunked_ce_loss(x, params["embed"]["emb"], labels,
                           chunk=cfg.ce_chunk)
