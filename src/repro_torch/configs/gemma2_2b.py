# Copy of repro/configs/gemma2_2b.py.
"""Gemma2-2B [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
— local+global alternating attention, logit softcaps, GeGLU, post-norms,
head_dim=256, query scale 256^-0.5.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256,
    layer_pattern=("attn_local", "attn"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0, query_scale=256 ** -0.5,
    mlp_act="gelu", use_post_norm=True, embed_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="gemma2-2b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, window=8, query_scale=16 ** -0.5,
    ce_chunk=32, attn_chunk=16,
)
