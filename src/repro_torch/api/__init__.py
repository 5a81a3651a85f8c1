"""``repro_torch.api`` — the offloaded-autodiff front-end of the port.

``value_and_grad_offloaded(model.train_loss, runner="fused")`` is the main
path: the paper's asynchronous multistage checkpointing over a
:class:`ChainSpec`, with the hand-written CUDA segment kernels on the card.
``runner="fused"`` corresponds to the JAX package's ``runner="pallas"``.
"""
from repro_torch.api.autotune import (GLOBAL_TUNER, AutoTuner, TuneResult,
                                      snap_interval)
from repro_torch.api.chain import ChainSpec, chain_length
from repro_torch.api.frontend import (OffloadConfig, last_plan, last_stats,
                                      last_tune, value_and_grad_offloaded)

__all__ = [
    "AutoTuner", "ChainSpec", "GLOBAL_TUNER", "OffloadConfig", "TuneResult",
    "chain_length", "last_plan", "last_stats", "last_tune", "snap_interval",
    "value_and_grad_offloaded",
]
