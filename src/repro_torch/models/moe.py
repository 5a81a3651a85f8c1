# Port of repro/models/moe.py: the dense gated MLP and the routed
# Mixture-of-Experts (both dispatch implementations, the routing statistics).
"""Feed-forward layers: dense gated MLPs and Mixture-of-Experts.

Two MoE dispatch implementations, both capacity-based and static-shaped:

* ``einsum`` — GShard-style one-hot dispatch/combine einsums (the
  default, ``ArchConfig.moe_impl``).  Its (tokens x experts x capacity)
  dispatch products cost O(k * N^2 * d / E) FLOPs.
* ``sorted``  — tokens are sorted by expert (a stable argsort), gathered
  into (E, C) buckets, run through a batched expert matmul, and gathered
  back.  Same numerics for kept tokens, ~O(N log N) dispatch cost.

Routing: top-k softmax gating with renormalised weights, the Switch
load-balance aux loss, ties broken toward the lower expert index (as
``lax.top_k`` does: ``torch.topk`` does not promise an order for ties, so
the choice is a stable descending sort), token dropping at capacity.

One deliberate difference from the JAX package: under overflow its
``moe_sorted`` writes the "empty" index over slot 0 of every overflowing
expert's bucket once for each dropped entry, so that expert's rank-0 token
loses its contribution.  Here the bucket scatter writes only kept entries,
so each expert keeps exactly ``min(count, C)`` tokens, as the docstring and
``with_stats`` of both packages say (ROADMAP queue 3).  Without overflow
the two agree.  The dispatch/combine products and the expert FFN are plain
matrix products, as in the JAX package (XLA there, outside any Pallas
kernel).  ``distributed.sharding.constrain`` is the identity on one device
and is dropped.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (DEFAULT_DTYPES, DTypes, dense, geglu,
                                       init_dense, normal, swiglu)

Params = Any


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def init_moe(generator, d_model: int, d_ff: int, n_experts: int, *,
             shared_expert: bool = False, shared_d_ff: Optional[int] = None,
             dtype=torch.float32, lead: Tuple[int, ...] = (),
             device=None) -> Params:
    """Stacked experts ``(*lead, E, d, d_ff)`` (``lead``: the period axis
    of ``init_lm``), the router and the optional shared expert."""
    def experts(d_in, d_out):
        return normal(generator, (*lead, n_experts, d_in, d_out),
                      d_in ** -0.5, device=device, dtype=dtype)

    p = {"router": init_dense(generator, d_model, n_experts, dtype=dtype,
                              lead=lead, device=device),
         "w_gate": experts(d_model, d_ff),
         "w_up": experts(d_model, d_ff),
         "w_down": experts(d_ff, d_model)}
    if shared_expert:
        p["shared"] = init_mlp(generator, d_model, shared_d_ff or d_ff,
                               dtype=dtype, lead=lead, device=device)
    return p


def _route(p, xg, n_experts: int, top_k: int):
    """Top-k softmax routing.  xg: (G, S, d) grouped tokens.  Returns
    (weights (G,S,k), indices (G,S,k), aux_loss)."""
    logits = torch.einsum("gsd,de->gse", xg.float(),
                          p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower index first among equals
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = srt[..., :top_k], order[..., :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx, n_experts).float().sum(2).mean(dim=(0, 1))
    aux = n_experts * torch.sum(me * ce)
    return weights, idx, aux


def _capacity(group_tokens: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(math.ceil(group_tokens * top_k * capacity_factor / n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def _expert_ffn(p, expert_in: torch.Tensor, act: str,
                dt: DTypes) -> torch.Tensor:
    """expert_in: (..., E, C, d) -> same, via the stacked expert weights."""
    g = torch.einsum("...ecd,edf->...ecf", expert_in, dt.c(p["w_gate"]))
    u = torch.einsum("...ecd,edf->...ecf", expert_in, dt.c(p["w_up"]))
    h = swiglu(g, u) if act == "silu" else geglu(g, u)
    return torch.einsum("...ecf,efd->...ecd", h, dt.c(p["w_down"]))


def _stats(routed_e: torch.Tensor, kept_e: torch.Tensor, C: int) -> dict:
    routed_e, kept_e = routed_e.to(torch.int32), kept_e.to(torch.int32)
    return {"expert_counts": kept_e, "routed_counts": routed_e,
            "dropped_tokens": torch.sum(routed_e - kept_e), "capacity": C}


def _einsum_slots(idx: torch.Tensor, n_experts: int, top_k: int, C: int):
    """The einsum dispatch's slot of each routing choice: per choice ``i``,
    the (G, S, E) expert mask and the position in that expert's buffer
    (choices ``i`` fill after every token's choices before ``i``), with
    ``keep`` where the position is within capacity."""
    G = idx.shape[0]
    prior = torch.zeros((G, n_experts), dtype=torch.int32, device=idx.device)
    for i in range(top_k):
        mask_i = F.one_hot(idx[..., i], n_experts).to(torch.int32)
        pos_i = torch.cumsum(mask_i, dim=1, dtype=torch.int32) - 1 \
            + prior[:, None, :]
        prior = prior + mask_i.sum(1, dtype=torch.int32)
        keep = (pos_i < C) & (mask_i > 0)
        yield mask_i, pos_i, keep


def moe_einsum(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float = 1.25, act: str = "silu",
               dt: DTypes = DEFAULT_DTYPES, with_stats: bool = False):
    """GShard one-hot dispatch, *grouped*: each batch row is one expert
    group with its own capacity.  x: (B, S, d).  Returns (y, aux_loss), or
    (y, aux_loss, stats) with ``with_stats=True`` (per-expert routed/kept
    counts and the ``dropped_tokens`` overflow; see :func:`routing_stats`).
    """
    G, S, d = x.shape
    weights, idx, aux = _route(p, x, n_experts, top_k)
    C = _capacity(S, n_experts, top_k, capacity_factor)
    slots = torch.arange(C, dtype=torch.int32, device=x.device)
    dispatch = torch.zeros((G, S, n_experts, C), dtype=dt.compute,
                           device=x.device)
    combine = torch.zeros((G, S, n_experts, C), dtype=torch.float32,
                          device=x.device)
    routed_e = torch.zeros((n_experts,), dtype=torch.int64, device=x.device)
    kept_e = torch.zeros_like(routed_e)
    for i, (mask_i, pos_i, keep) in enumerate(
            _einsum_slots(idx, n_experts, top_k, C)):
        if with_stats:
            routed_e = routed_e + mask_i.sum((0, 1))
            kept_e = kept_e + keep.sum((0, 1))
        # one-hot of the kept position (a dropped choice's row is all 0)
        d_i = (torch.where(keep, pos_i, C)[..., None] == slots)
        dispatch = dispatch + d_i.to(dt.compute)
        # where, not a product with the mask: the same values, and
        # autograd keeps the boolean mask rather than an fp32 copy
        combine = combine + torch.where(d_i, weights[..., i, None, None],
                                        0.0)

    expert_in = torch.einsum("gsd,gsec->gecd", x.to(dt.compute), dispatch)
    expert_out = _expert_ffn(p, expert_in, act, dt)
    y = torch.einsum("gecd,gsec->gsd", expert_out.float(), combine)
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + mlp(p["shared"], x, act=act, dt=dt)
    if with_stats:
        return y, aux, _stats(routed_e, kept_e, C)
    return y, aux


def _sorted_buckets(idx: torch.Tensor, n_experts: int, top_k: int, C: int):
    """Per group: each expert's bucket of token indices (E, C), ``S`` where
    empty; each routing choice's flat bucket slot (S*k,), ``E*C`` where
    dropped; and the routed counts (E,).  Only kept entries are
    scattered."""
    G, S, _ = idx.shape
    dev = idx.device
    flat_e = idx.reshape(G, S * top_k)
    flat_tok = torch.arange(S, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1)               # slot -> sorted pos
    se = torch.gather(flat_e, 1, order)
    st = flat_tok[order]
    counts = F.one_hot(flat_e, n_experts).sum(1)     # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(S * top_k, device=dev) - torch.gather(starts, 1, se)
    keep = rank < C
    bucket_tok = torch.full((G, n_experts * C), S, dtype=torch.int64,
                            device=dev)
    g_of = torch.arange(G, device=dev)[:, None].expand_as(se)
    bucket_tok[g_of[keep], (se * C + rank)[keep]] = st[keep]
    slot_bucket = torch.where(keep, se * C + rank,
                              torch.full_like(se, n_experts * C))
    slot_bucket = torch.gather(slot_bucket, 1, inv)
    return bucket_tok.reshape(G, n_experts, C), slot_bucket, counts


def moe_sorted(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float = 1.25, act: str = "silu",
               dt: DTypes = DEFAULT_DTYPES, with_stats: bool = False):
    """Sort-based dispatch: the grouping and capacity of ``moe_einsum`` (up
    to drop order) without the O(S*E*C) one-hot tensors.  Dispatch and
    combine are gathers; the combine looks up each token's k expert-output
    slots through the inverse sort permutation.  Each expert keeps exactly
    ``min(count, C)`` entries (the first in token order).  ``with_stats``
    appends the stats of :func:`moe_einsum` (the per-expert counts are the
    same; the drop order differs)."""
    G, S, d = x.shape
    weights, idx, aux = _route(p, x, n_experts, top_k)
    C = _capacity(S, n_experts, top_k, capacity_factor)
    bucket_tok, slot_bucket, counts = _sorted_buckets(idx, n_experts, top_k,
                                                      C)
    x_pad = torch.cat([x.to(dt.compute),
                       torch.zeros((G, 1, d), dtype=dt.compute,
                                   device=x.device)], dim=1)
    expert_in = torch.gather(
        x_pad, 1, bucket_tok.reshape(G, -1, 1).expand(-1, -1, d)
    ).reshape(G, n_experts, C, d)
    expert_out = _expert_ffn(p, expert_in, act, dt)
    out_flat = torch.cat([expert_out.reshape(G, n_experts * C, d),
                          torch.zeros((G, 1, d), dtype=expert_out.dtype,
                                      device=x.device)], dim=1)
    tok_out = torch.gather(
        out_flat, 1, slot_bucket.reshape(G, -1, 1).expand(-1, -1, d)
    ).reshape(G, S, top_k, d)
    y = torch.einsum("gskd,gsk->gsd", tok_out.float(), weights).to(x.dtype)
    if "shared" in p:
        y = y + mlp(p["shared"], x, act=act, dt=dt)
    if with_stats:
        return y, aux, _stats(counts.sum(0),
                              torch.clamp(counts, max=C).sum(0), C)
    return y, aux


def moe_apply(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              impl: str = "einsum", dt: DTypes = DEFAULT_DTYPES,
              with_stats: bool = False):
    """Dispatch to the selected MoE impl.  Returns ``(y, aux_loss)``, or
    ``(y, aux_loss, stats)`` with ``with_stats=True`` (``dropped_tokens``
    plus per-expert ``expert_counts``/``routed_counts``)."""
    fn = {"einsum": moe_einsum, "sorted": moe_sorted}[impl]
    return fn(p, x, n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, act=act, dt=dt,
              with_stats=with_stats)


def routing_stats(p: Params, x, *, n_experts: int, top_k: int,
                  capacity_factor: float = 1.25) -> dict:
    """Host-side routing statistics of one MoE layer application: plain
    numpy ``{"expert_counts", "routed_counts", "dropped_tokens",
    "capacity"}``, with the einsum dispatch's keep accounting;
    ``expert_counts`` are post-capacity *kept* loads."""
    x = torch.as_tensor(x)
    G, S, _ = x.shape
    with torch.no_grad():
        _, idx, _ = _route(p, x, n_experts, top_k)
        C = _capacity(S, n_experts, top_k, capacity_factor)
        routed = np.zeros((n_experts,), np.int32)
        kept = np.zeros((n_experts,), np.int32)
        for mask_i, _, keep in _einsum_slots(idx, n_experts, top_k, C):
            routed += mask_i.sum((0, 1)).cpu().numpy().astype(np.int32)
            kept += keep.sum((0, 1)).cpu().numpy().astype(np.int32)
    return {"expert_counts": kept, "routed_counts": routed,
            "dropped_tokens": int(routed.sum() - kept.sum()),
            "capacity": int(C)}
