"""The port's hybrid family (``jamba-v0.1-52b``, 24 layers) against the JAX package, on the CPU at
SMOKE width: ``train_loss`` and its gradients, and the offloaded gradient
against dense autograd with the JAX package's plan and counters (cases and
tolerances: ``tests/_transformer_cases.py``).
"""
import pytest
from _transformer_cases import (check_offloaded_gradient,
                                check_train_loss_matches_jax)


@pytest.mark.parametrize("arch,seq,batch,kw", [
    # three periods of (mamba, mamba_moe, mamba, attn_moe, ...)
    ("jamba-v0.1-52b", None, None, {"n_layers": 24}),
])
def test_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch):
    check_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch)


@pytest.mark.parametrize("arch,n_layers,interval,slots", [
    ("jamba-v0.1-52b", 24, 2, 2),   # 3 periods of 8 layers: a tail of 1
])
def test_offloaded_gradient_matches_dense_and_jax_plan(arch, n_layers,
                                                       interval, slots):
    check_offloaded_gradient(arch, n_layers, interval, slots)
