# Copy of repro/configs/base.py (framework-free); keep the two in step.
"""Config system: architecture + shape suite + runtime knobs.

Every assigned architecture is one ``<id>.py`` module exporting ``CONFIG``
(the exact published configuration) and ``SMOKE`` (a reduced same-family
variant for CPU smoke tests).  ``repro.configs.registry`` collects them.

``layer_pattern`` describes one *period* of the layer stack; the stack is
``n_layers / len(layer_pattern)`` repetitions of the pattern, scanned with
stacked parameters (so heterogeneous stacks — Gemma-2's local/global
alternation, Jamba's Mamba:attention interleave — become uniform chains,
which is exactly the uniform-checkpoint-size assumption the paper's strategy
wants; see DESIGN §2).

Layer kinds:
  ``attn``        attention + dense MLP
  ``attn_local``  sliding-window attention + dense MLP
  ``attn_moe``    attention + MoE FFN
  ``mamba``       Mamba-2 mixer (no FFN)
  ``mamba_moe``   Mamba-2 mixer + MoE FFN
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    ngroups: int = 1
    conv_k: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm | lstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("attn",)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding-window size for *_local layers
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    use_post_norm: bool = False      # Gemma-2 style post-norms
    embed_scale: bool = False        # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    dec_len: int = 448               # decoder length for train/prefill shapes
    # vlm
    n_patches: int = 0
    # --- runtime knobs (hillclimbed in EXPERIMENTS §Perf) -------------------
    remat_policy: str = "offload_layer"
    moe_impl: str = "einsum"
    attn_chunk: int = 1024
    ce_chunk: int = 512
    scan_unroll: int = 1
    sharding_profile: str = "tp"     # tp | dp (replicate params, batch over
                                     # every mesh axis — small models)
    pad_vocab_multiple: int = 0      # pad embedding rows so vocab shards
                                     # evenly (0 = exact published vocab)
    zero3: bool = False              # constrain projection outputs so FSDP
                                     # weights are all-gathered, never
                                     # resolved by activation all-reduces
    sub_quadratic: bool = False      # True -> runs the long_500k shape

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        if not m:
            return self.vocab
        return -(-self.vocab // m) * m

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers,
                                                  self.period)
        return self.n_layers // self.period

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Reduced shape used by per-arch smoke tests (CPU, one real device).
SMOKE_SHAPE = ShapeSpec("smoke", 32, 2, "train")


def applicable_shapes(cfg: ArchConfig):
    """The shape cells this architecture runs (skips per assignment rules)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # needs sub-quadratic attention; skip noted in DESIGN.md
        out.append(s)
    return out


def param_count(cfg: ArchConfig) -> Tuple[int, int]:
    """(total_params, active_params) — analytic, used for MODEL_FLOPS."""
    d, hd = cfg.d_model, cfg.hd
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    total = emb
    active = emb
    for kind in cfg.layer_pattern:
        attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) \
            + (cfg.n_heads * hd) * d
        dense_ffn = 3 * d * cfg.d_ff
        if cfg.ssm is not None:
            s = cfg.ssm
            d_in = s.expand * d
            nheads = d_in // s.headdim
            mamba = d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads) \
                + d_in * d + s.conv_k * (d_in + 2 * s.ngroups * s.d_state)
        else:
            mamba = 0
        if kind in ("attn", "attn_local"):
            lt = la = attn + dense_ffn
        elif kind == "attn_moe":
            m = cfg.moe
            lt = attn + m.n_experts * dense_ffn \
                + (dense_ffn if m.shared_expert else 0) + d * m.n_experts
            la = attn + m.top_k * dense_ffn \
                + (dense_ffn if m.shared_expert else 0) + d * m.n_experts
        elif kind == "mamba":
            lt = la = mamba
        elif kind == "mamba_moe":
            m = cfg.moe
            lt = mamba + m.n_experts * dense_ffn + d * m.n_experts
            la = mamba + m.top_k * dense_ffn + d * m.n_experts
        else:
            raise ValueError(kind)
        total += lt * cfg.n_periods
        active += la * cfg.n_periods
    if cfg.n_enc_layers:
        enc = cfg.n_enc_layers * (4 * d * cfg.n_heads * hd + 3 * d * cfg.d_ff)
        xattn = cfg.n_layers * (2 * d * cfg.n_heads * hd +
                                2 * d * cfg.n_kv_heads * hd)
        total += enc + xattn
        active += enc + xattn
    return total, active


def _attn_layer_counts(cfg: ArchConfig):
    """(n_global_attn, n_local_attn) layers in the decoder stack."""
    ng = sum(1 for k in cfg.layer_pattern
             if k in ("attn", "attn_moe")) * cfg.n_periods
    nl = sum(1 for k in cfg.layer_pattern
             if k == "attn_local") * cfg.n_periods
    return ng, nl


def model_flops(cfg: ArchConfig, spec: ShapeSpec) -> float:
    """Useful model FLOPs per step: 6·N_active·D (train) / 2·N_active·D
    (inference) plus the quadratic attention term (4·B·H·hd·S·S_eff per
    layer, halved for causal masking, windowed for local layers; x3 for the
    backward pass in training).  SSD linear-time mixing is inside the 6ND
    term.  This is the numerator of the roofline's useful-compute ratio.
    """
    _, active = param_count(cfg)
    B, S = spec.global_batch, spec.seq_len
    hd, H = cfg.hd, cfg.n_heads
    ng, nl = _attn_layer_counts(cfg)
    win = min(cfg.window or S, S)

    if spec.kind == "train":
        tokens = B * (cfg.dec_len if cfg.family == "encdec" else S)
        attn = 2 * B * H * hd * (ng * S * S + nl * S * win)  # causal half
        if cfg.family == "encdec":
            s_enc = S // 2
            attn = 2 * B * H * hd * cfg.n_enc_layers * s_enc * s_enc * 2 \
                + 2 * B * H * hd * cfg.n_layers * (
                    cfg.dec_len * cfg.dec_len + 2 * cfg.dec_len * s_enc)
        return 6.0 * active * tokens + 3.0 * attn
    if spec.kind == "prefill":
        tokens = B * (cfg.dec_len if cfg.family == "encdec" else S)
        attn = 2 * B * H * hd * (ng * S * S + nl * S * win)
        if cfg.family == "encdec":
            s_enc = S // 2
            attn = 2 * B * H * hd * cfg.n_enc_layers * s_enc * s_enc * 2 \
                + 2 * B * H * hd * cfg.n_layers * (
                    cfg.dec_len * cfg.dec_len + 2 * cfg.dec_len * s_enc)
        return 2.0 * active * tokens + attn
    # decode: one token; attention reads the full cache (or window)
    attn = 4.0 * B * H * hd * (ng * S + nl * win)
    if cfg.family == "encdec":
        attn = 4.0 * B * H * hd * cfg.n_layers * (S + 1500)
    return 2.0 * active * B + attn


def score_materialization_bytes(cfg: ArchConfig, spec: ShapeSpec) -> float:
    """HBM bytes the XLA-portable chunked attention / SSD paths spend on f32
    score (resp. intra-chunk decay) tensors — traffic that the Pallas TPU
    kernels keep VMEM-resident.  Subtracting this from the (fusion-
    discounted) jaxpr-model bytes gives the kernel-adjusted memory term
    in §Roofline.

    Tensor counts match the implementations under the fusion-discounted
    model (major score tensors + 0.25x the fusable ones): attention — fwd
    materializes the score dot `s`; bwd re-materializes `s`, `dp`, `ds`
    (4 major, ~1 discounted elementwise) -> 4 effective train, 1 inference.
    SSD — `cb` fwd + `dcb`/`dM` bwd -> 4 train, 1.5 inference.  Each counted
    as one write + one read of f32.
    """
    B, S = spec.global_batch, spec.seq_len
    H = cfg.n_heads
    ng, nl = _attn_layer_counts(cfg)
    win = min(cfg.window or S, S)
    n_attn = 4.0 if spec.kind == "train" else 1.0
    n_ssd = 4.0 if spec.kind == "train" else 1.5
    total = 0.0
    if spec.kind in ("train", "prefill"):
        attn_elems = B * H * (ng * S * S + nl * S * win)
        if cfg.family == "encdec":
            s_enc = S // 2
            attn_elems = B * H * (
                cfg.n_enc_layers * s_enc * s_enc
                + cfg.n_layers * (cfg.dec_len * cfg.dec_len
                                  + cfg.dec_len * s_enc))
        total += n_attn * 2 * 4.0 * attn_elems
        if cfg.ssm is not None:
            n_mamba = sum(1 for k in cfg.layer_pattern
                          if k.startswith("mamba")) * cfg.n_periods
            s_ssm = cfg.ssm
            d_in = s_ssm.expand * cfg.d_model
            heads = d_in // s_ssm.headdim
            # (b, n_chunks, L, L, h) decay/cb tensors, f32
            total += n_ssd * 2 * 4.0 * B * (S // max(s_ssm.chunk, 1)) * \
                s_ssm.chunk * s_ssm.chunk * heads * n_mamba
    else:  # decode: (B, H, 1, S) rows — small but counted
        total += n_attn * 2 * 4.0 * B * H * (ng * S + nl * win)
    return total
