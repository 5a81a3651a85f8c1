# Copy of repro/configs/whisper_tiny.py.
"""Whisper-tiny [audio/encdec]: 4L(enc)+4L(dec) d_model=384 6H d_ff=1536
vocab=51865 — conv frontend STUB (precomputed frame embeddings).
[arXiv:2212.04356; unverified]  Norms/positions adapted to the RMSNorm+RoPE
substrate (DESIGN §2); dims follow the published config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, mlp_act="gelu", tie_embeddings=True,
    dec_len=448,
)

SMOKE = CONFIG.replace(
    name="whisper-tiny-smoke", n_layers=2, n_enc_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, dec_len=16, ce_chunk=16,
    attn_chunk=16,
)
