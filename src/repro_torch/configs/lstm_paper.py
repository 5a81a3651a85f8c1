# Copy of repro/configs/lstm_paper.py.
"""The paper's own §5 test case: a vanilla LSTM for character-level text
generation, trained with RMSProp.  d_model = embedding dim, d_ff = hidden."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="lstm-paper", family="lstm",
    n_layers=1, d_model=64, n_heads=1, n_kv_heads=1, d_ff=256,
    vocab=96, tie_embeddings=False, sub_quadratic=True,
)

SMOKE = CONFIG.replace(name="lstm-paper-smoke", d_model=16, d_ff=32,
                       vocab=64)
