"""The port's SSM family (``mamba2-370m``) against the JAX package, on the CPU at
SMOKE width: ``train_loss`` and its gradients, and the offloaded gradient
against dense autograd with the JAX package's plan and counters (cases and
tolerances: ``tests/_transformer_cases.py``).
"""
import pytest
from _transformer_cases import (check_offloaded_gradient,
                                check_train_loss_matches_jax)


@pytest.mark.parametrize("arch,seq,batch,kw", [
    ("mamba2-370m", None, None, {}),
])
def test_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch):
    check_train_loss_matches_jax(arch, seq, batch, kw, monkeypatch)


@pytest.mark.parametrize("arch,n_layers,interval,slots", [
    # 5 periods: segments 3 (chunked under checkpoint, s=2) and 2
    ("mamba2-370m", 5, 3, 2),
])
def test_offloaded_gradient_matches_dense_and_jax_plan(arch, n_layers,
                                                       interval, slots):
    check_offloaded_gradient(arch, n_layers, interval, slots)
