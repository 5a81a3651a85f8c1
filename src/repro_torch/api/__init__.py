"""``repro_torch.api`` — the offloaded-autodiff front-end of the port.

``value_and_grad_offloaded(model.train_loss, runner="fused")`` is the main
path: the paper's asynchronous multistage checkpointing over a
:class:`ChainSpec`, with the hand-written CUDA segment kernels on the card.
``runner="fused"`` corresponds to the JAX package's ``runner="pallas"``.
``strategy="revolve"``/``"conventional"`` and ``engine="interpreted"`` are
the paper's baselines and its step-granular interpreter;
``checkpointed_bptt`` wraps a ``body(params, carry, x) -> (carry, loss_k)``
scan.
"""
from repro_torch.api.autotune import (GLOBAL_TUNER, AutoTuner, TuneResult,
                                      snap_interval)
from repro_torch.api.chain import ChainSpec, chain_length
from repro_torch.api.frontend import (OffloadConfig, checkpointed_bptt,
                                      last_plan, last_stats, last_tune,
                                      value_and_grad_offloaded)

__all__ = [
    "AutoTuner", "ChainSpec", "GLOBAL_TUNER", "OffloadConfig", "TuneResult",
    "chain_length", "checkpointed_bptt", "last_plan", "last_stats",
    "last_tune", "snap_interval", "value_and_grad_offloaded",
]
