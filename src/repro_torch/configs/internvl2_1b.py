# Copy of repro/configs/internvl2_1b.py.
"""InternVL2-1B [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
— InternViT frontend (STUB: precomputed patch embeddings) + Qwen2-0.5B-style
LM backbone (QKV bias).  [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655, qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    n_patches=1024,
)

SMOKE = CONFIG.replace(
    name="internvl2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, n_patches=8, ce_chunk=32,
    attn_chunk=16,
)
