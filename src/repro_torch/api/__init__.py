"""``repro_torch.api`` — the offloaded-autodiff front-end of the port.

``value_and_grad_offloaded(model.train_loss, runner="fused")`` is the main
path: the paper's asynchronous multistage checkpointing over a
:class:`ChainSpec`, with the hand-written CUDA segment kernels on the card.
``runner="fused"`` corresponds to the JAX package's ``runner="pallas"``.
``strategy="revolve"``/``"conventional"`` and ``engine="interpreted"`` are
the paper's baselines and its step-granular interpreter, and
``engine="scan"`` runs the same plan inside one autograd graph (what its
boundaries moved: ``last_scan()``); ``checkpointed_bptt`` wraps a
``body(params, carry, x) -> (carry, loss_k)`` scan.  ``journal_dir=`` makes
a run crash-consistent and ``resume_offloaded`` finishes a crashed one from
its journal.  ``offload_params="moe_experts"`` streams a MoE chain's expert
weights through Level 2.
"""
from repro_torch.api.autotune import (GLOBAL_TUNER, AutoTuner, TuneResult,
                                      snap_interval)
from repro_torch.api.chain import ChainSpec, chain_length
from repro_torch.api.frontend import (ENGINES, STORAGE_KINDS, STRATEGIES,
                                      OffloadConfig, checkpointed_bptt,
                                      last_plan, last_stats, last_tune,
                                      offloaded_loss, resume_offloaded,
                                      value_and_grad_offloaded)
from repro_torch.core.faults import StorageFault  # typed Level-2 failure root
from repro_torch.core.offload import ScanRecord
from repro_torch.core.offload import last_record as last_scan

__all__ = [
    "AutoTuner", "ChainSpec", "ENGINES", "GLOBAL_TUNER", "OffloadConfig",
    "STORAGE_KINDS", "STRATEGIES", "ScanRecord", "StorageFault",
    "TuneResult", "chain_length", "checkpointed_bptt", "last_plan",
    "last_scan", "last_stats", "last_tune", "offloaded_loss",
    "resume_offloaded", "snap_interval", "value_and_grad_offloaded",
]
