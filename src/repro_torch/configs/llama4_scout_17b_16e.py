# Copy of repro/configs/llama4_scout_17b_16e.py.
"""Llama4-Scout-17B-16E [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
(expert), vocab=202048, MoE 16e top-1 + shared expert — early fusion
multimodal in the published model; the text backbone is built here and the
fusion frontend is out of assigned scope (text shapes only).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="llama4-scout-17b-16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, rope_theta=5e5, tie_embeddings=False,
    layer_pattern=("attn_moe",),
    moe=MoECfg(n_experts=16, top_k=1, shared_expert=True,
               capacity_factor=2.0),
)

SMOKE = CONFIG.replace(
    name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512,
    moe=MoECfg(n_experts=4, top_k=1, shared_expert=True, capacity_factor=2.0),
    ce_chunk=32, attn_chunk=16,
)
