# Copy of repro/configs/phi3_5_moe.py.
"""Phi-3.5-MoE-42B (6.6B active) [moe]: 32L d_model=4096 32H (GQA kv=8)
d_ff=6400, vocab=32064, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="phi3.5-moe-42b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, rope_theta=1e4, tie_embeddings=False,
    layer_pattern=("attn_moe",),
    moe=MoECfg(n_experts=16, top_k=2),
)

SMOKE = CONFIG.replace(
    name="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, moe=MoECfg(n_experts=4, top_k=2), ce_chunk=32,
    attn_chunk=16,
)
