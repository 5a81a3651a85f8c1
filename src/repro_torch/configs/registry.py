# Port of repro/configs/registry.py: the ported families' architectures.
"""Architecture registry: ``--arch <id>`` resolution.

Ported: the paper's LSTM, ``gemma2-2b`` (dense) and ``mamba2-370m`` (ssm).
Every other architecture of the JAX package's registry raises
``NotImplementedError`` until its model family is ported (ROADMAP queue 1,
item 10)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "lstm-paper": "lstm_paper",
    "gemma2-2b": "gemma2_2b",
    "mamba2-370m": "mamba2_370m",
}

# The JAX package's other architectures (repro/configs/registry.py).
_NOT_PORTED = (
    "qwen1.5-4b", "yi-6b", "granite-3-2b", "internvl2-1b",
    "jamba-v0.1-52b", "whisper-tiny", "llama4-scout-17b-16e",
    "phi3.5-moe-42b",
)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} belongs to a model family the port does not "
            "have yet (ROADMAP queue 1, item 10)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
