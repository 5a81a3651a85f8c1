"""The LSTM cell's CUDA source (``csrc/lstm_cell.cu``: the single step and
the step loop), run on the CPU under an emulation of the CUDA runtime
(``tests/_cuda_emu.py``), against its plain version; and the per-step
strategies through the front door on it.  The emulation checks the
kernels' arithmetic, indexing, masking and synchronisation order here; it
does not check ``nvcc``, speed or the card's memory model
(``chip_smoke.py`` and ``test_torch_cuda.py`` do, on the card).
Tolerances as in ``test_torch_kernels.py``.  The fused segment kernels,
flash attention and the SSD scan have files of their own
(``test_torch_cuda_emulated_{segment,flash,ssd}.py``).
"""
import numpy as np
import pytest
import torch
from _cuda_emu import (V, _np, _segment, card_paths, cell_on_card,  # noqa: F401
                       emulated_libs)

from repro_torch import api
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels.ref import lstm_cell_ref
from repro_torch.models import lstm

@pytest.mark.parametrize("Bn,Dx,Dh,dtype", [
    (37, 8, 40, torch.float32),    # ragged batch and unit edges
    (5, 16, 32, torch.bfloat16),
])
def test_lstm_cell_kernel_source(card_paths, Bn, Dx, Dh, dtype):
    rng = np.random.default_rng(Bn)
    x, h, c, w, b = [torch.tensor(a).to(dtype) for a in (
        _np(rng, (Bn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), 0.1), _np(rng, (4 * Dh,), 0.1))]
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    before = lc.lstm_cell.launches
    lc._launch("lstm_cell_f32" if dtype == torch.float32 else
               "lstm_cell_bf16", x, None, h, c, w, b, h_out, c_out, None,
               None)
    assert lc.lstm_cell.launches == before + 1
    hp, cp = lc.lstm_cell(x, h, c, w, b)   # the plain version (CPU)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(h_out.float(), hp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(c_out.float(), cp.float(), rtol=tol, atol=tol)


def _check_token_steps(Bn, Dx, Dh, Vn, L, seed, **kw):
    """``L`` steps of the step loop (the fused reverse's recompute) as one
    call, against ``lstm_cell_ref`` step by step: each step's states, [x, h]
    rows and gate activations."""
    rng = np.random.default_rng(seed)
    emb, h, c, w, b = [torch.tensor(a) for a in (
        _np(rng, (Vn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), 0.1), _np(rng, (4 * Dh,), 0.1))]
    tok = torch.tensor(rng.integers(0, Vn, (L, Bn)), dtype=torch.int32)
    hs, cs = torch.full((L + 1, Bn, Dh), -7.0), torch.full((L + 1, Bn, Dh),
                                                            -7.0)
    hs[0], cs[0] = h, c
    xh = torch.full((L, Bn, Dx + Dh), -7.0)
    acts = torch.full((L, Bn, 4 * Dh), -7.0)
    before = (lc.lstm_cell.launches, lc.lstm_cell.steps)
    lc._token_steps(tok, emb, hs, cs, w, b, xh, acts, **kw)
    assert (lc.lstm_cell.launches, lc.lstm_cell.steps) == (
        before[0] + 1, before[1] + L)
    for t in range(L):
        x = emb[tok[t].long()]
        hr, cr = lstm_cell_ref(x, hs[t], cs[t], w, b)
        torch.testing.assert_close(hs[t + 1], hr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cs[t + 1], cr, rtol=1e-5, atol=1e-5)
        assert torch.equal(xh[t], torch.cat([x, hs[t]], 1))
        i, f, o, g = (torch.cat([x, hs[t]], 1) @ w + b).chunk(4, 1)
        torch.testing.assert_close(
            acts[t], torch.cat([torch.sigmoid(i), torch.sigmoid(f + 1),
                                torch.sigmoid(o), torch.tanh(g)], 1),
            rtol=1e-5, atol=1e-5)


def test_lstm_cell_gather_variant_writes_its_side_outputs(card_paths):
    """Three steps of the step loop in one call, a ragged batch and unit
    tile (B=9, Dh=36)."""
    _check_token_steps(9, 8, 36, 11, 3, seed=3)


@pytest.mark.parametrize("Bn,Dx,Dh,L,blocks_y", [
    (70, 8, 40, 4, 0),   # 5 row tiles on 2 resident row blocks: each loops
    (37, 6, 20, 3, 0),   # Dx, Dh not multiples of 4: the 4-byte copies
    (20, 8, 12, 3, 5),   # more row blocks than row tiles: idle blocks
])
def test_lstm_cell_step_loop(card_paths, Bn, Dx, Dh, L, blocks_y):
    _check_token_steps(Bn, Dx, Dh, 13, L, seed=Bn, blocks_y=blocks_y)


def test_lstm_cell_step_loop_equals_single_steps(card_paths):
    """A step of the loop and the single-step kernel take a slice's rows
    in the same order: the same bits."""
    rng = np.random.default_rng(4)
    Bn, Dx, Dh, Vn, L = 21, 8, 40, 9, 2
    emb, w, b = [torch.tensor(a) for a in (
        _np(rng, (Vn, Dx)), _np(rng, (Dx + Dh, 4 * Dh), 0.1),
        _np(rng, (4 * Dh,), 0.1))]
    tok = torch.tensor(rng.integers(0, Vn, (L, Bn)), dtype=torch.int32)
    hs = torch.tensor(_np(rng, (L + 1, Bn, Dh)))
    cs = torch.tensor(_np(rng, (L + 1, Bn, Dh)))
    lc._token_steps(tok, emb, hs, cs, w, b, None, None)
    h, c = hs[0].clone(), cs[0].clone()
    for t in range(L):
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
        lc._launch("lstm_cell_f32", emb[tok[t].long()].contiguous(), None,
                   h, c, w, b, h_out, c_out, None, None)
        assert torch.equal(h_out, hs[t + 1]) and torch.equal(c_out, cs[t + 1])
        h, c = h_out, c_out



def test_lstm_cell_kernel_under_autograd(cell_on_card):
    """``lstm_cell_autograd``: the kernel forward (one launch), and as
    backward the vjp of the plain cell recomputed from the saved inputs (no
    launch); gradients of every input within 1e-5 of plain autograd through
    ``lstm_cell_ref``."""
    rng = np.random.default_rng(21)
    Bn, Dx, Dh = 9, 8, 20
    ins = [torch.tensor(a) for a in (
        _np(rng, (Bn, Dx)), _np(rng, (Bn, Dh)), _np(rng, (Bn, Dh)),
        _np(rng, (Dx + Dh, 4 * Dh), 0.2), _np(rng, (4 * Dh,), 0.1))]
    gh, gc = (torch.tensor(_np(rng, (Bn, Dh))) for _ in range(2))

    def grads(cell):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        h, c = cell(*leaves)
        return (h, c), torch.autograd.grad(
            (h * gh).sum() + (c * gc).sum(), leaves)

    (h, c), g = grads(lc.lstm_cell_autograd)
    assert cell_on_card.launches == 1
    (hr, cr), gr = grads(lstm_cell_ref)
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, cr, rtol=1e-5, atol=1e-5)
    for a, b in zip(g, gr):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,forward_steps", [
    ({"strategy": "conventional"}, 19),
    ({"strategy": "revolve", "slots": 4}, 19),
    ({"engine": "interpreted", "interval": 7, "slots": 3}, 0),
])
def test_strategies_run_the_cell_kernel_once_a_step(cell_on_card, kw,
                                                    forward_steps):
    """Through the front door, every chain step of the per-step strategies
    runs the cell kernel once: the forward sweep that computes ``x_n`` (the
    baselines'; the multistage forward is the executor's own), each
    advance, and each backward's recompute.  Loss and gradients agree with
    dense autograd of the plain cell."""
    params, _, _, _ = _segment(1, 1, seed=14)
    tok = torch.tensor(np.random.default_rng(2).integers(0, V, (4, 20)),
                       dtype=torch.int32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = lstm.forward_loss(leaves, tok)
    dense = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    v, g = api.value_and_grad_offloaded(lstm.train_chain(), device="cpu",
                                        **kw)(params, {"tokens": tok})
    stats = api.last_stats()
    assert cell_on_card.launches == (forward_steps + stats.advances
                                     + stats.backwards)
    torch.testing.assert_close(v, loss.detach(), rtol=1e-5, atol=0)
    for k in dense:
        torch.testing.assert_close(g[k], dense[k], rtol=1e-4,
                                   atol=1e-4 * float(dense[k].abs().max()))
