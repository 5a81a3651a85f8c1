# Port of repro/configs/registry.py: every architecture of the JAX package.
"""Architecture registry: ``--arch <id>`` resolution.

The paper's LSTM, the dense (``gemma2-2b``, ``qwen1.5-4b``, ``yi-6b``,
``granite-3-2b``), SSM (``mamba2-370m``), MoE (``phi3.5-moe-42b``,
``llama4-scout-17b-16e``) and hybrid (``jamba-v0.1-52b``) decoders, the VLM
(``internvl2-1b``) and the encoder-decoder (``whisper-tiny``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma2-2b": "gemma2_2b",
    "yi-6b": "yi_6b",
    "granite-3-2b": "granite_3_2b",
    "internvl2-1b": "internvl2_1b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-tiny": "whisper_tiny",
    "llama4-scout-17b-16e": "llama4_scout_17b_16e",
    "phi3.5-moe-42b": "phi3_5_moe",
    "mamba2-370m": "mamba2_370m",
    "lstm-paper": "lstm_paper",
}


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
