# Copy of repro/configs/granite_3_2b.py.
"""Granite-3.0-2B [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA, tied embeddings.  [hf:ibm-granite/granite-3.0-2b-base; hf]
(The scalar logits/residual/embedding multipliers of Granite are folded into
initialisation; noted in DESIGN §2.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=49155, rope_theta=1e4, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, ce_chunk=32, attn_chunk=16,
)
