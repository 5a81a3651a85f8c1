"""The slice end to end on the CPU: gemma2-2b's chain body (an
``attn_local`` and an ``attn`` layer a chain step) through
``value_and_grad_offloaded(runner="fused")`` with its hand-written kernels
(``flash_attention`` and its backward, ``rmsnorm``, ``glu``, ``rope``)
compiled under the emulation of ``tests/_cuda_emu.py`` and launched through
their wrappers' card paths on CPU tensors, against the JAX package's
``runner="pallas"`` (the decoder body traced into its segment kernels, run
in interpret mode) on the same weights and tokens, in fp32 compute: loss
within 1e-5 relative, each gradient leaf within 1e-4 of its max |g|, every
kernel launched as often as the plan implies.  SMOKE width, 4 layers
(two chain steps, chunks of one step: a chunk entry stored, one recomputed
in the reverse), B=1, S=32; both packages take their chunked (flash-style) attention at this
length (their default switches to the dense oracle up to 2,048 tokens).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.models.attention as j_attn
import repro.models.transformer as j_tf
from _cuda_emu import emulated_libs, kernels_on_card  # noqa: F401
from _transformer_cases import _case
from repro import api as j_api
from repro.models.layers import DTypes as JDTypes
from repro.models.model_factory import get_model as j_get_model
from repro_torch import api
from repro_torch.convert import params_from_numpy
from repro_torch.core.schedule import chunk_length
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import glu as glu_mod
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import rope as rope_mod
from repro_torch.kernels.segment_fused import forward_bounds, reverse_layout
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import DTypes
from repro_torch.models.model_factory import get_model

N_LAYERS, INTERVAL, SLOTS, BATCH = 4, 2, 2, 1
# launches a chain step (two layers): forward kernels each time a step
# runs, backward kernels once a step in the reverse; the readout's final
# norm once each way
FORWARD = {"flash_attention": 2, "rope": 2, "glu": 2, "rmsnorm": 8}
BACKWARD = {"flash_attention_bwd": 2, "rope_bwd": 2, "glu_bwd": 2,
            "rmsnorm_bwd": 8}
HEAD = {"rmsnorm": 1, "rmsnorm_bwd": 1}
WRAPPERS = {"flash_attention": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rope": rope_mod.rope, "rope_bwd": rope_mod.rope_bwd,
            "glu": glu_mod.glu, "glu_bwd": glu_mod.glu_bwd,
            "rmsnorm": rn.rmsnorm, "rmsnorm_bwd": rn.rmsnorm_bwd}


def _counts():
    return {k: (fa.flash_attention if k == "flash_attention" else fn)
            .launches for k, fn in WRAPPERS.items()}


def _chunked(attention):
    """``attention`` with its chunked path at any length."""
    @functools.wraps(attention)
    def forced(*args, **kw):
        return attention(*args, **{**kw, "use_chunked": True})
    return forced


def _expected(plan, slots):
    """Each kernel's launches for ``plan``: the forward sweep runs every
    step once, the fused reverse recomputes each segment's chunk entries
    but the last chunk's and runs every chunk once more inside its vjp."""
    fwd_steps = rev_steps = 0
    for seg in plan.segments:
        L = seg.length
        chunk = chunk_length(L, slots) or L
        c, nc, _ = reverse_layout(L, chunk)
        assert forward_bounds(L, chunk)[-1] == L
        fwd_steps += L
        rev_steps += (nc - 1) * c + L
    want = {k: n * (fwd_steps + rev_steps) for k, n in FORWARD.items()}
    want.update({k: n * fwd_steps for k, n in BACKWARD.items()})
    for k, n in HEAD.items():
        want[k] += n
    return want


def test_gemma_fused_with_emulated_kernels_matches_jax_pallas(
        emulated_libs, kernels_on_card, monkeypatch):
    emulated_libs.prebuild(["flash_attention", "flash_attention_bwd",
                            "rmsnorm", "glu", "rope"])
    monkeypatch.setattr(j_tf, "_dtypes",
                        lambda c: JDTypes(compute=jnp.float32))
    monkeypatch.setattr(tf, "_dtypes", lambda c: DTypes(compute=torch.float32))
    monkeypatch.setattr(j_attn, "attention", _chunked(j_attn.attention))
    monkeypatch.setattr(attn_mod, "attention", _chunked(attn_mod.attention))
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    j_cfg, cfg, params, j_batch, t_batch = _case("gemma2-2b", batch=BATCH,
                                                 n_layers=N_LAYERS)
    j_vg = j_api.value_and_grad_offloaded(
        j_get_model(j_cfg).train_loss, interval=INTERVAL, slots=SLOTS,
        runner="pallas")
    j_loss, j_grads = j_vg(jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, j_batch))
    assert j_api.last_stats().fused_segments > 0   # the segment kernels ran

    vg = api.value_and_grad_offloaded(get_model(cfg).train_loss,
                                      interval=INTERVAL, slots=SLOTS,
                                      runner="fused", device="cpu")
    before = _counts()
    loss, grads = vg(params_from_numpy(params, device="cpu"), t_batch)
    launched = {k: n - before[k] for k, n in _counts().items()}
    assert launched == _expected(api.last_plan(), SLOTS)
    assert api.last_plan().plan_id == j_api.last_plan().plan_id

    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    leaves = pytree.tree_leaves(grads)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(leaves) == len(j_leaves)
    for i, (g, jg) in enumerate(zip(leaves, j_leaves)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape, i
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert float(np.abs(g.numpy() - jg).max()) <= 1e-4 * scale, i
