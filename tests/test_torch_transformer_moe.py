"""The port's MoE family (``phi3.5-moe-42b``, ``llama4-scout-17b-16e``) against the JAX package, on the CPU at
SMOKE width: ``train_loss`` and its gradients, and the offloaded gradient
against dense autograd with the JAX package's plan and counters (cases and
tolerances: ``tests/_transformer_cases.py``).
"""
import pytest
from _transformer_cases import (check_offloaded_gradient,
                                check_train_loss_matches_jax)


@pytest.mark.parametrize("arch,seq,batch,kw", [
    ("phi3.5-moe-42b", None, None, {}),    # top-2 of 4 experts
    # top-1 with a shared expert, capacity factor 2.0
    ("llama4-scout-17b-16e", None, None, {}),
])
def test_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch):
    check_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch)


@pytest.mark.parametrize("arch,n_layers,interval,slots", [
    ("phi3.5-moe-42b", 5, 3, 2),
    ("llama4-scout-17b-16e", 6, 2, 2),
])
def test_offloaded_gradient_matches_dense_and_jax_plan(arch, n_layers,
                                                       interval, slots):
    check_offloaded_gradient(arch, n_layers, interval, slots)
