# Copy of repro/configs/jamba_v0_1_52b.py.
"""Jamba-v0.1-52B [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba:attention 1:7 interleave, MoE every 2nd
layer.  [arXiv:2403.19887; hf]

Period of 8 layers: one attention layer per period (1:7), MoE on every odd
position.  Jamba's attention uses no positional embedding (the Mamba layers
carry position); we keep RoPE off by setting theta on the attention layers
only through the shared config — adaptation noted in DESIGN §2.
"""
from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, tie_embeddings=False,
    layer_pattern=("mamba", "mamba_moe", "mamba", "attn_moe",
                   "mamba", "mamba_moe", "mamba", "mamba_moe"),
    moe=MoECfg(n_experts=16, top_k=2),
    ssm=SSMCfg(d_state=16, headdim=64, expand=2, ngroups=1, conv_k=4),
    sub_quadratic=True,
)

SMOKE = CONFIG.replace(
    name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512,
    moe=MoECfg(n_experts=4, top_k=2),
    ssm=SSMCfg(d_state=8, headdim=16, expand=2, ngroups=1, conv_k=4, chunk=8),
    ce_chunk=32, attn_chunk=16,
)
