"""``runner="fused"`` for a generic chain body (not the registered LSTM
step) on the CPU, where the ``entry_store`` and ``fold`` wrappers run their
plain versions: the port against the JAX package's ``runner="pallas"`` with
the Pallas kernels in interpret mode, on the same numpy-seeded inputs.

* The ports of ``tests/test_kernels.py:191`` (a chain whose body is
  ``lstm_cell_ref``) and ``:220`` (a diagonal SSM chain with differentiable
  float inputs, whose reverse writes input cotangents): loss within 1e-5
  relative, each gradient leaf within 1e-4 of its max |g|, the plan and
  every executor counter (``fused_segments`` and ``fused_boundary_copies``
  included) equal; against the port's own ``runner="compiled"`` the loss
  is bit for bit (the forward runs the same operations in the same order).
* gemma2-2b (10 layers), mamba2-370m (7 layers) and phi3.5-moe (4
  layers: its MoE body) at SMOKE width in fp32
  compute, weights from the JAX package's ``init_lm``, under the same
  gates.
* The plain fold's association: chunks from the last one down, a short
  tail chunk's cotangent last, broadcast zeros skipped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.models.transformer as j_tf
from repro import api as j_api
from repro.api.chain import ChainSpec as JChainSpec
from repro.kernels import ref as j_ref
from repro.models.layers import DTypes as JDTypes
from repro.models.model_factory import get_model as j_get_model
from repro_torch import api
from repro_torch.api.chain import ChainSpec, is_broadcast_zero
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref
from repro_torch.kernels import segment_fused as sf
from repro_torch.kernels import segment_generic as sg
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTypes
from repro_torch.models.model_factory import get_model

from _transformer_cases import COUNTERS, _case


def _jax_run(spec, params, batch, interval, slots, runner, monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    vg = j_api.value_and_grad_offloaded(spec, interval=interval, slots=slots,
                                        runner=runner)
    loss, grads = vg(jax.tree_util.tree_map(jnp.asarray, params),
                     jax.tree_util.tree_map(jnp.asarray, batch))
    return (np.asarray(loss), [np.asarray(g) for g in
                               jax.tree_util.tree_leaves(grads)],
            j_api.last_plan().plan_id, j_api.last_stats())


def _port_run(spec, params, batch, interval, slots, runner):
    vg = api.value_and_grad_offloaded(spec, interval=interval, slots=slots,
                                      runner=runner, device="cpu")
    loss, grads = vg(params, batch)
    return (loss, [g.numpy() for g in pytree.tree_leaves(grads)],
            api.last_plan().plan_id, api.last_stats())


def _assert_parity(port, ref_run, compiled):
    loss, grads, plan_id, stats = port
    j_loss, j_grads, j_plan_id, j_stats = ref_run
    assert j_stats.fused_segments > 0   # the interpret-mode kernels ran
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert len(grads) == len(j_grads)
    for i, (g, jg) in enumerate(zip(grads, j_grads)):
        assert g.shape == jg.shape, i
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert float(np.abs(g - jg).max()) <= 1e-4 * scale, i
    assert plan_id == j_plan_id
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(j_stats, name), name
    # the port's compiled runner: the same forward, so the same loss bits
    assert torch.equal(loss, compiled[0])
    assert compiled[2] == plan_id


def _counts():
    return sg.entry_store.launches, sg.fold.launches


def _check_launches(before, stats):
    """The plain versions count no launch."""
    assert _counts() == before
    assert stats.fused_segments > 0


# ------------------------------------------------- the reference's chains

def _ref_lstm_specs(B, Dx, Dh):
    def j_prelude(p, batch):
        z = jnp.zeros((B, Dh))
        return (z, z, jnp.float32(0.0)), batch["xs"]

    def j_body(p, carry, x, batch):
        h, c, acc = carry
        h, c = j_ref.lstm_cell_ref(x, h, c, p["w"], p["b"])
        return (h, c, acc + jnp.sum(h ** 2))

    def prelude(p, batch):
        z = torch.zeros((B, Dh))
        return (z, z, torch.tensor(0.0)), batch["xs"]

    def body(p, carry, x, batch):
        h, c, acc = carry
        h, c = ref.lstm_cell_ref(x, h, c, p["w"], p["b"])
        return (h, c, acc + torch.sum(h ** 2))

    return (JChainSpec(j_prelude, j_body, lambda p, c, b: c[2],
                       name="ref-lstm-chain"),
            ChainSpec(prelude, body, lambda p, c, b: c[2],
                      name="ref-lstm-chain"))


def _ssm_specs(B, D):
    def j_prelude(p, batch):
        return (jnp.zeros((B, D)), jnp.float32(0.0)), batch["xs"]

    def j_body(p, carry, x, batch):
        h, acc = carry
        h = jnp.exp(-jax.nn.softplus(p["logA"])) * h + x @ p["Bm"]
        return (h, acc + jnp.mean((h @ p["Cm"]) ** 2))

    def prelude(p, batch):
        return (torch.zeros((B, D)), torch.tensor(0.0)), batch["xs"]

    def body(p, carry, x, batch):
        h, acc = carry
        h = torch.exp(-torch.nn.functional.softplus(p["logA"])) * h \
            + x @ p["Bm"]
        return (h, acc + torch.mean((h @ p["Cm"]) ** 2))

    return (JChainSpec(j_prelude, j_body, lambda p, c, b: c[1],
                       name="ssm-chain"),
            ChainSpec(prelude, body, lambda p, c, b: c[1], name="ssm-chain"))


def _chain_case(kind):
    rng = np.random.default_rng(32 if kind == "ref_lstm" else 34)
    if kind == "ref_lstm":   # test_kernels.py:191
        B, Dx, Dh, T = 2, 4, 6, 29
        params = {"b": np.zeros((4 * Dh,), np.float32),
                  "w": (rng.standard_normal((Dx + Dh, 4 * Dh)) * 0.2).astype(
                      np.float32)}
        xs = (rng.standard_normal((T, B, Dx)) * 0.5).astype(np.float32)
        return _ref_lstm_specs(B, Dx, Dh), params, {"xs": xs}, 8, 4
    B, D, T = 3, 8, 41   # test_kernels.py:220
    params = {"Bm": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
              "Cm": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
              "logA": (rng.standard_normal((D,)) * 0.1).astype(np.float32)}
    xs = (rng.standard_normal((T, B, D)) * 0.4).astype(np.float32)
    return _ssm_specs(B, D), params, {"xs": xs}, 16, 4


@pytest.mark.parametrize("kind", ["ref_lstm", "ssm"])
def test_generic_chain_matches_jax_pallas(kind, monkeypatch):
    (j_spec, spec), params, batch, interval, slots = _chain_case(kind)
    assert sf.body_kind(spec.body) == sf.GENERIC
    j = _jax_run(j_spec, params, batch, interval, slots, "pallas",
                 monkeypatch)
    t_params = {k: torch.tensor(v) for k, v in params.items()}
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    before = _counts()
    port = _port_run(spec, t_params, t_batch, interval, slots, "fused")
    _check_launches(before, port[3])
    compiled = _port_run(spec, t_params, t_batch, interval, slots,
                         "compiled")
    _assert_parity(port, j, compiled)


# ------------------------------------------------------------ the decoders

@pytest.mark.parametrize("arch,n_layers,interval,slots,copies", [
    ("gemma2-2b", 10, 5, 2, 6),     # one segment, chunks 3, 2
    ("mamba2-370m", 7, 7, 3, 8),    # forward chunks 3, 4; reverse 3, 3, 1
    ("phi3.5-moe-42b", 4, 4, 2, 6),  # a MoE body: chunks 2, 2
])
def test_decoder_matches_jax_pallas(arch, n_layers, interval, slots, copies,
                                    monkeypatch):
    monkeypatch.setattr(j_tf, "_dtypes", lambda c: JDTypes(compute=jnp.float32))
    monkeypatch.setattr(tf, "_dtypes", lambda c: DTypes(compute=torch.float32))
    j_cfg, cfg, params, j_batch, t_batch = _case(arch, n_layers=n_layers)
    j = _jax_run(j_get_model(j_cfg).train_loss, params, j_batch, interval,
                 slots, "pallas", monkeypatch)
    assert (j[3].fused_segments, j[3].fused_boundary_copies) == (2, copies)
    model = get_model(cfg)
    t_params = params_from_numpy(params, device="cpu")
    before = _counts()
    port = _port_run(model.train_loss, t_params, t_batch, interval, slots,
                     "fused")
    _check_launches(before, port[3])
    compiled = _port_run(model.train_loss, t_params, t_batch, interval,
                         slots, "compiled")
    _assert_parity(port, j, compiled)


# ------------------------------------------------------ the fold's order

def test_plain_fold_association(monkeypatch):
    """The reverse folds each chunk from the last one down, each into the
    accumulator in place, and a short tail chunk's cotangent last (after
    chunk 0's, in chunk 0's launch; its rows in its own); a broadcast-zero
    cotangent (a parameter the chunk does not read) is skipped."""
    calls = []
    fold = sg.fold

    def recording(gacc, dps, dst_rows=(), src_rows=()):
        calls.append(([r.data_ptr() for r in dst_rows],
                      [{k: (is_broadcast_zero(v), v.clone())
                        for k, v in dp.items()} for dp in dps]))
        return fold(gacc, dps, dst_rows, src_rows)

    monkeypatch.setattr(sg, "fold", recording)

    def body(p, c, x, batch):
        return torch.tanh(c * p["a"] + x)

    T, chunk = 11, 4   # reverse chunks 4, 4, 3: the tail [8, 11) is short
    xs = torch.linspace(-1.0, 1.0, T * 3).reshape(T, 3)
    params = {"a": torch.tensor(0.7), "unread": torch.ones(5)}
    gacc = {"a": torch.tensor(0.25), "unread": torch.zeros(()).expand(5)}
    rows = [torch.zeros(T, 3)]
    dc, got = sg.reverse(body, (True,), params, torch.zeros(3), xs, None,
                         torch.ones(3), gacc, rows, chunk=chunk)
    base, step = rows[0].data_ptr(), rows[0].stride(0) * 4
    # one launch a chunk, from the last one down, each with its rows
    assert [r[0] for r, _ in calls] == [base + 8 * step, base + 4 * step,
                                        base]
    # the tail's cotangent: none in its own launch, last in chunk 0's
    assert [len(dps) for _, dps in calls] == [0, 1, 2]
    want = torch.tensor(0.25)
    for _, dps in calls:
        for dp in dps:
            assert dp["unread"][0] and not dp["a"][0]   # never read
            want = want + dp["a"][1]
    assert torch.equal(got["a"], want)          # in this order
    assert got["a"] is gacc["a"]                # added in place
    assert is_broadcast_zero(got["unread"])
    # the rows hold the input cotangents of dense autograd
    xg = xs.clone().requires_grad_(True)
    c = torch.zeros(3)
    for k in range(T):
        c = body(params, c, xg[k], None)
    (gx,) = torch.autograd.grad(c, [xg], torch.ones(3))
    torch.testing.assert_close(rows[0], gx, rtol=1e-5, atol=1e-6)
