# Copy of repro/configs/mamba2_370m.py.
"""Mamba2-370M [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

This is the paper's RNN case at modern scale: BPTT over the sequence with
uniform SSM states as checkpoints; runs the long_500k shape (sub-quadratic).
"""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, tie_embeddings=True,
    layer_pattern=("mamba",),
    ssm=SSMCfg(d_state=128, headdim=64, expand=2, ngroups=1, conv_k=4,
               chunk=128),
    sub_quadratic=True,
)

SMOKE = CONFIG.replace(
    name="mamba2-370m-smoke", n_layers=2, d_model=64, vocab=512,
    ssm=SSMCfg(d_state=8, headdim=16, expand=2, ngroups=1, conv_k=4, chunk=8),
    ce_chunk=32,
)
