# Port of repro/models/transformer.py: init, the full-sequence layer path,
# train_loss and the depth chain (the dense, MoE, hybrid and ssm families).
"""Decoder-only LM assembly (the dense, MoE, hybrid and SSM families).

The layer stack is organised in *periods* (``cfg.layer_pattern``):
parameters for each pattern position are stacked over ``n_periods``, so the
model depth is literally the paper's checkpoint chain, with uniform
per-period states.  :func:`train_loss` loops over the periods;
:func:`train_chain` hands the same computation to the offloaded autodiff
with one period per chain step.

Left out until their item: caches, ``prefill`` and ``decode`` (ROADMAP
queue 1, item 14).  ``remat_layer`` (the JAX package's
per-period remat/offload policy) is a memory policy of the scanned stack and
is not applied: the offloaded chain is the port's memory policy
(ROADMAP queue 3).  ``distributed.sharding.constrain`` is the identity on
one device and is dropped.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (DTypes, chunked_ce_loss, embed,
                                       init_embedding, init_rmsnorm, rmsnorm,
                                       rmsnorm_fanout, rope_angles)

Params = Any
KINDS = ("attn", "attn_local", "attn_moe", "mamba", "mamba_moe")


def _dtypes(cfg: ArchConfig) -> DTypes:
    return DTypes(compute=torch.bfloat16)


def _check_kinds(cfg: ArchConfig) -> None:
    for kind in cfg.layer_pattern:
        if kind not in KINDS:
            raise ValueError(f"unknown layer kind {kind!r} ({cfg.name}); "
                             f"known: {KINDS}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(generator, cfg: ArchConfig, kind: str, lead, device
                ) -> Params:
    """One pattern position's parameters, stacked over ``lead``."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": init_rmsnorm(d, lead=lead, device=device)}
    if kind.startswith("attn"):
        p["attn"] = attn_mod.init_attention(
            generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            qkv_bias=cfg.qkv_bias, lead=lead, device=device)
    else:  # mamba
        s = cfg.ssm
        p["mamba"] = ssm_mod.init_mamba2(
            generator, d, d_state=s.d_state, headdim=s.headdim,
            expand=s.expand, ngroups=s.ngroups, conv_k=s.conv_k, lead=lead,
            device=device)
    if cfg.use_post_norm:
        p["ln1_post"] = init_rmsnorm(d, lead=lead, device=device)
    if kind in ("attn", "attn_local", "attn_moe", "mamba_moe"):
        p["ln2"] = init_rmsnorm(d, lead=lead, device=device)
        if kind.endswith("_moe"):
            p["moe"] = moe_mod.init_moe(
                generator, d, cfg.d_ff, cfg.moe.n_experts,
                shared_expert=cfg.moe.shared_expert, lead=lead,
                device=device)
        else:
            p["mlp"] = moe_mod.init_mlp(generator, d, cfg.d_ff, lead=lead,
                                        device=device)
        if cfg.use_post_norm:
            p["ln2_post"] = init_rmsnorm(d, lead=lead, device=device)
    return p


def init_lm(generator: torch.Generator, cfg: ArchConfig, *,
            device=None) -> Params:
    """Random parameters with ``init_lm``'s keys, layouts and
    distributions, drawn from ``generator`` on its own device (a CUDA
    generator draws full-width weights on the card) and placed on
    ``device`` (the card unless ``device="cpu"``).  The draws differ from
    the JAX package's (another generator)."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.padded_vocab, cfg.d_model,
                                device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(generator, cfg.padded_vocab,
                                           cfg.d_model, device=dev)
    params["layers"] = {
        f"pos{j}": _init_layer(generator, cfg, kind, (cfg.n_periods,), dev)
        for j, kind in enumerate(cfg.layer_pattern)}
    return params


def unembed_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return (params["embed"]["emb"] if cfg.tie_embeddings
            else params["unembed"]["emb"])


# ---------------------------------------------------------------------------
# layer application (full-sequence path)
# ---------------------------------------------------------------------------


def _post(p, name, x, y, cfg, dt):
    """``x + post_norm(y)`` (the norm and the add one kernel on the card)
    with post-norms, else ``y``, whose producer added the skip ``x``."""
    if cfg.use_post_norm:
        return rmsnorm(p[name], y, dt=dt, residual=x)
    return y


def _ffn(p, h, kind, cfg, dt, aux=None):
    """The feed-forward half of a layer: ``(h, aux)``, ``aux`` the running
    total (None: none yet) plus a MoE layer's aux loss."""
    if "mlp" not in p and "moe" not in p:
        return h, aux
    # the norm's output for two readers and h for the skip: their
    # cotangents meet in the norm's backward kernel on the card
    y_a, y_b, h = rmsnorm_fanout(p["ln2"], h, 2, dt=dt)
    res = None if cfg.use_post_norm else h
    if "moe" in p:
        y, aux = moe_mod.moe_apply(
            p["moe"], y_b, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor, act=cfg.mlp_act,
            impl=cfg.moe_impl, dt=dt, x_route=y_a, residual=res,
            aux_in=aux)
    else:
        y = moe_mod.mlp(p["mlp"], (y_a, y_b), act=cfg.mlp_act, dt=dt,
                        residual=res)
    return _post(p, "ln2_post", h, y, cfg, dt), aux


def _apply_layer_seq(p, x, kind, cfg: ArchConfig, rope, dt,
                     causal: bool = True, aux=None):
    """Full-sequence layer (training compute).  Returns (x, aux): ``aux``
    the running total given (None: none yet) plus a MoE layer's aux loss.
    The pre-norms pass ``x`` on as the residual's skip, which the layer's
    last kernel adds (the output projection, the MoE combine, or a
    post-norm)."""
    if kind.startswith("attn"):
        *ys, x = rmsnorm_fanout(p["ln1"], x, 3, dt=dt)   # q, k, v; skip
        res = None if cfg.use_post_norm else x
        window = cfg.window if kind == "attn_local" else None
        y = attn_mod.attention(
            p["attn"], tuple(ys), n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, rope=rope,
            causal=causal, window=window, softcap=cfg.attn_softcap,
            scale=cfg.query_scale, chunk=cfg.attn_chunk, dt=dt,
            residual=res)
    else:
        s = cfg.ssm
        y, x = rmsnorm_fanout(p["ln1"], x, 1, dt=dt)
        res = None if cfg.use_post_norm else x
        y = ssm_mod.mamba2_block(
            p["mamba"], y, d_state=s.d_state, headdim=s.headdim,
            expand=s.expand, ngroups=s.ngroups, conv_k=s.conv_k,
            chunk=s.chunk, dt=dt, residual=res)
    h = _post(p, "ln1_post", x, y, cfg, dt)
    return _ffn(p, h, kind, cfg, dt, aux)


def _aux_coef(cfg: ArchConfig) -> float:
    return cfg.moe.aux_coef if cfg.moe else 0.0


def _embed_tokens(params, inp, cfg, dt):
    h = embed(params["embed"], inp, dt, tied=cfg.tie_embeddings)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt.compute)
    return h


def _periods(layers: Params):
    """The stacked layer tree as one tree per period.  ``unbind`` rather
    than indexing: its backward stacks the per-period gradients once,
    where each index's backward would allocate a zero-filled gradient of
    the whole stack."""
    leaves, spec = pytree.tree_flatten(layers)
    cols = [torch.unbind(leaf) for leaf in leaves]
    return [pytree.tree_unflatten([col[i] for col in cols], spec)
            for i in range(len(cols[0]))]


def _scan_stack(params, h, cfg: ArchConfig, rope, dt):
    """The layer stack over the hidden states ``h``, one period at a time.
    Returns ``(h, aux)``, ``aux`` the summed MoE aux losses."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in _periods(params["layers"]):
        # the period's aux first, then the running total, as the JAX
        # package's scan body adds them (a layer without one adds +0.0,
        # left out: the totals start at +0.0)
        aux_p = torch.zeros((), dtype=torch.float32, device=h.device)
        for j, kind in enumerate(cfg.layer_pattern):
            h, a = _apply_layer_seq(lp[f"pos{j}"], h, kind, cfg, rope, dt)
            if a is not None:
                aux_p = aux_p + a
        aux = aux + aux_p
    return h, aux


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig) -> torch.Tensor:
    """batch["tokens"]: (B, S+1) int32.  Mean next-token NLL (+ MoE aux)."""
    _check_kinds(cfg)
    dt = _dtypes(cfg)
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    S = inp.shape[1]
    h = _embed_tokens(params, inp, cfg, dt)
    rope = rope_angles(S, cfg.hd, cfg.rope_theta, like=h)
    h, aux = _scan_stack(params, h, cfg, rope, dt)
    h = rmsnorm(params["final_norm"], h, dt=dt)
    loss = chunked_ce_loss(h, unembed_weight(params, cfg), labels,
                           chunk=cfg.ce_chunk, logit_cap=cfg.logit_softcap,
                           mask=batch.get("mask"), valid_vocab=cfg.vocab)
    return loss + _aux_coef(cfg) * aux / max(1, cfg.n_layers)


# ---------------------------------------------------------------------------
# chain decomposition (repro_torch.api): depth is the checkpoint chain
# ---------------------------------------------------------------------------


def train_chain(cfg: ArchConfig):
    """``ChainSpec`` decomposition of :func:`train_loss`.

    The chain axis is *depth*: one period of the layer pattern is one chain
    step, the hidden state (plus the MoE aux accumulator) is the carry, and
    the stacked per-period parameters are the per-step inputs ``xs`` — so
    their gradients flow back into ``params["layers"]`` through the
    prelude.  Values and gradients match ``train_loss``; only the
    activation-memory strategy differs.
    """
    from repro_torch.api.chain import ChainSpec

    _check_kinds(cfg)
    dt = _dtypes(cfg)

    def prelude(params, batch):
        h = _embed_tokens(params, batch["tokens"][:, :-1], cfg, dt)
        return ((h, torch.zeros((), dtype=torch.float32, device=h.device)),
                params["layers"])

    def layer_body(params, carry, lp, batch, j):
        # one layer of the period (the rope table is rebuilt per layer, on
        # the card inside the rope kernel); a MoE layer adds its aux loss
        # to the carry's (in the routing kernel on the card), another
        # passes the carry's on (the JAX package adds +0.0 to it)
        x, aux_t = carry
        S = batch["tokens"].shape[1] - 1
        rope = rope_angles(S, cfg.hd, cfg.rope_theta, like=x)
        kind = cfg.layer_pattern[j]
        return _apply_layer_seq(lp[f"pos{j}"], x, kind, cfg, rope, dt,
                                aux=aux_t)

    def body(params, carry, lp, batch):
        for j in range(len(cfg.layer_pattern)):
            carry = layer_body(params, carry, lp, batch, j)
        return carry

    def readout_chunked(params, carry, batch, head_chunks):
        x, aux_t = carry
        labels = batch["tokens"][:, 1:]
        S = labels.shape[1]
        h = rmsnorm(params["final_norm"], x, dt=dt)
        chunk = cfg.ce_chunk if head_chunks <= 1 \
            else max(1, -(-S // head_chunks))
        loss = chunked_ce_loss(h, unembed_weight(params, cfg), labels,
                               chunk=chunk, logit_cap=cfg.logit_softcap,
                               mask=batch.get("mask"),
                               valid_vocab=cfg.vocab)
        return loss + _aux_coef(cfg) * aux_t / max(1, cfg.n_layers)

    def readout(params, carry, batch):
        return readout_chunked(params, carry, batch, 1)

    return ChainSpec(prelude, body, readout, name=f"{cfg.name}-depth",
                     layer_body=layer_body,
                     n_layers=len(cfg.layer_pattern),
                     readout_chunked=readout_chunked)
