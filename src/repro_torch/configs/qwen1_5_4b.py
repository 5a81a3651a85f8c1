# Copy of repro/configs/qwen1_5_4b.py.
"""Qwen1.5-4B [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab=151936, qkv_bias=True, rope_theta=1e6, tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="qwen1.5-4b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, ce_chunk=32, attn_chunk=16,
)
