# Copy of repro/configs/yi_6b.py.
"""Yi-6B [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab=64000, rope_theta=5e6, tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="yi-6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, ce_chunk=32, attn_chunk=16,
)
