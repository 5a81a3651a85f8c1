"""Architecture configs (ported subset: the paper's LSTM, gemma2-2b and
mamba2-370m)."""
from repro_torch.configs.base import SHAPES, SMOKE_SHAPE, ArchConfig, ShapeSpec
from repro_torch.configs.registry import get_config

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "SMOKE_SHAPE", "get_config"]
