"""Architecture configs (ported subset: the paper's LSTM and the decoder
families: dense, SSM, MoE and hybrid)."""
from repro_torch.configs.base import SHAPES, SMOKE_SHAPE, ArchConfig, ShapeSpec
from repro_torch.configs.registry import get_config

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "SMOKE_SHAPE", "get_config"]
