"""A parameter gradient that autograd hands back broadcast (all strides 0,
values not zero) reaches the caller on every strategy, engine and runner
of the port, as the JAX package's does.

The chain ``c' = tanh(c * p["w"] + x) + p["s"].sum()`` with readout
``(c ** 2).sum()``: ``p["s"]`` is read through a sum, whose backward
expands its cotangent, so a one-step vjp gives ``p["s"]`` a stride-0
gradient.  Inputs from a numpy seed; the port's loss and gradients within
1e-5 of ``repro.api.value_and_grad_offloaded``'s on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro_torch import api

D = 5


def _inputs(n, seed=3):
    rng = np.random.default_rng(seed)
    params = {"w": rng.uniform(0.5, 1.5, (D,)).astype(np.float32),
              "s": rng.uniform(-0.5, 0.5, (2,)).astype(np.float32)}
    batch = {"c0": (rng.standard_normal((D,)) * 0.3).astype(np.float32),
             "xs": (rng.standard_normal((n, D)) * 0.3).astype(np.float32)}
    return params, batch


def _spec(chain, xp):
    return chain.ChainSpec(
        prelude=lambda p, b: (b["c0"], b["xs"]),
        body=lambda p, c, x, b: xp.tanh(c * p["w"] + x) + p["s"].sum(),
        readout=lambda p, c, b: (c ** 2).sum(),
        name="broadcast-grad-chain")


def _jax(n, kw):
    from repro.api import chain as j_chain

    params, batch = _inputs(n)
    kw = {k: v for k, v in kw.items() if k != "runner"}
    loss, grads = j_api.value_and_grad_offloaded(_spec(j_chain, jnp), **kw)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: np.asarray(g) for k, g in grads.items()}


def _port(n, kw):
    from repro_torch.api import chain as t_chain

    params, batch = _inputs(n)
    loss, grads = api.value_and_grad_offloaded(
        _spec(t_chain, torch), device="cpu", **kw)(
        {k: torch.as_tensor(v) for k, v in params.items()},
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), grads


@pytest.mark.parametrize("kw", [
    {"interval": 1, "slots": 2},
    {"interval": 2, "slots": 2},
    {"interval": 3, "slots": 2},
    {"strategy": "revolve", "slots": 2},
    {"strategy": "conventional"},
    {"engine": "interpreted", "interval": 3, "slots": 2},
    {"runner": "fused", "interval": 3, "slots": 2},
], ids=["compiled-I1", "compiled-I2", "compiled-I3", "revolve",
        "conventional", "interpreted", "fused-plain"])
@pytest.mark.parametrize("n", [7, 8])
def test_broadcast_parameter_gradient_reaches_the_caller(n, kw):
    j_loss, j_grads = _jax(n, kw)
    loss, grads = _port(n, kw)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    for k, g in j_grads.items():
        assert grads[k] is not None, k
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
    # the chain reads p["s"] at every step: its gradient is not zero
    assert np.abs(j_grads["s"]).max() > 0.1
