# Port of repro/models/lstm.py (the executor and chain paths).
"""Vanilla LSTM for text generation — the paper's §5 test case.

A single-cell LSTM unrolled over the sequence (one *recurrence* == one chain
step == one checkpoint), token prediction loss at every step, trained with
RMSProp.  The chain state is ``(h, c, loss_acc)``; carrying the loss
accumulator in the state makes the whole thing a pure chain with adjoint
seed ``(0, 0, 1)``.

Parameters are a plain dict with the JAX package's keys and layouts
(``emb (V, Dx)``, ``w (Dx+Dh, 4Dh)`` gate-major ``i, f, o, g``, ``b``,
``w_out (Dh, V)``, ``b_out``).  The executor's per-step operators
(:func:`make_operators`) and the chain body run the cell through the
``lstm_cell`` kernel (its plain version on CPU tensors);
:func:`forward_loss`, the reference the offloaded paths are held to, keeps
the plain cell.  ``bptt_loss_and_grad`` needs the scan engine (ROADMAP
queue 1, item 13).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import segment_fused
from repro_torch.kernels.lstm_cell import lstm_cell_autograd

Params = Any


def init_lstm(generator: torch.Generator, vocab: int, d_embed: int,
              d_hidden: int, dtype=torch.float32, *, device=None) -> Params:
    """Random parameters drawn from ``generator`` (a CPU generator), placed
    on ``device`` (the card unless ``device="cpu"``).  Same distributions as
    the JAX package's ``init_lstm``; the draws differ (another generator)."""
    dev = resolve_device(device)
    scale = (d_embed + d_hidden) ** -0.5

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=dtype) * std

    params = {
        "emb": normal((vocab, d_embed), 0.1),
        "w": normal((d_embed + d_hidden, 4 * d_hidden), scale),
        "b": torch.zeros((4 * d_hidden,), dtype=dtype),
        "w_out": normal((d_hidden, vocab), d_hidden ** -0.5),
        "b_out": torch.zeros((vocab,), dtype=dtype),
    }
    return {k: v.to(dev) for k, v in params.items()}


def lstm_cell(params: Params, h: torch.Tensor, c: torch.Tensor,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM recurrence.  x: (B, d_embed) input embedding."""
    z = torch.cat([x, h], dim=-1) @ params["w"] + params["b"]
    i, f, o, g = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def kernel_cell(params: Params, h: torch.Tensor, c: torch.Tensor,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lstm_cell` through the ``lstm_cell`` kernel (its plain version
    on CPU tensors), differentiable."""
    return lstm_cell_autograd(x, h, c, params["w"], params["b"])


def step_loss(params: Params, h: torch.Tensor, c: torch.Tensor,
              tok: torch.Tensor, target: torch.Tensor, cell=lstm_cell):
    """One chain step: consume token ``tok``, predict ``target``.
    Returns (h', c', nll)."""
    x = params["emb"][tok.long()]
    h, c = cell(params, h, c, x)
    logits = h @ params["w_out"] + params["b_out"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, target.long()[:, None])[:, 0]
    return h, c, torch.mean(lse - gold)


def init_state(batch: int, d_hidden: int, dtype=torch.float32, *,
               device=None):
    dev = resolve_device(device)
    return (torch.zeros((batch, d_hidden), dtype=dtype, device=dev),
            torch.zeros((batch, d_hidden), dtype=dtype, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev))


def forward_loss(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Plain step loop (the reference the offloaded paths are held to).
    ``tokens``: (B, T+1) — step k consumes tokens[:, k], predicts
    tokens[:, k+1]."""
    B, Tp1 = tokens.shape
    h, c, acc = init_state(B, params["w"].shape[1] // 4,
                           params["w"].dtype, device=tokens.device)
    for k in range(Tp1 - 1):
        h, c, nll = step_loss(params, h, c, tokens[:, k], tokens[:, k + 1])
        acc = acc + nll
    return acc


# ---------------------------------------------------------------------------
# Executor path (paper-faithful)
# ---------------------------------------------------------------------------


def make_operators(params: Params, tokens: torch.Tensor):
    """``(forward_op, backward_op, adjoint_seed, T)`` for the checkpoint
    executor.  ``tokens``: (B, T+1) — step k consumes tokens[:, k],
    predicts tokens[:, k+1].  The adjoint is ``(dstate, grads_accum)``."""
    T = tokens.shape[1] - 1

    def _step(p, state, k):
        h, c, acc = state
        h, c, nll = step_loss(p, h, c, tokens[:, k], tokens[:, k + 1],
                              cell=kernel_cell)
        return (h, c, acc + nll)

    def fwd(state, k):
        with torch.no_grad():
            return _step(params, state, k)

    def bwd(state, adjoint, k):
        dstate, gacc = adjoint
        with torch.enable_grad():
            p = {n: v.detach().requires_grad_(True)
                 for n, v in params.items()}
            s = tuple(t.detach().requires_grad_(True) for t in state)
            grads = torch.autograd.grad(_step(p, s, k),
                                        [*p.values(), *s], dstate)
        gacc = {n: gacc[n] + g for n, g in zip(p, grads)}
        return (tuple(grads[len(p):]), gacc)

    def adjoint_seed():
        zero_g = {n: torch.zeros_like(v) for n, v in params.items()}
        # dstate mirrors (h, c, acc): zeros for h/c, 1.0 for the loss accum.
        h0, c0, acc0 = init_state(tokens.shape[0], params["w"].shape[1] // 4,
                                  params["w"].dtype, device=tokens.device)
        return ((h0, c0, torch.ones_like(acc0)), zero_g)

    return fwd, bwd, adjoint_seed, T


# ---------------------------------------------------------------------------
# Chain decomposition (repro_torch.api): time is the checkpoint chain
# ---------------------------------------------------------------------------


def _prelude(params, batch):
    tokens = batch["tokens"]
    carry0 = init_state(tokens.shape[0], params["w"].shape[1] // 4,
                        params["w"].dtype, device=tokens.device)
    xs = (tokens[:, :-1].T, tokens[:, 1:].T)  # (T, B) each
    return carry0, xs


def _chain_step(params, carry, x, cell):
    h, c, acc = carry
    tok, tgt = x
    h, c, nll = step_loss(params, h, c, tok, tgt, cell=cell)
    return (h, c, acc + nll)


def _body(params, carry, x, batch):
    return _chain_step(params, carry, x, kernel_cell)


def plain_body(params, carry, x, batch):
    """The chain step with the plain cell: what the fused kernels' plain
    versions run as their yardstick on the card (``_body`` there launches
    the ``lstm_cell`` kernel)."""
    return _chain_step(params, carry, x, lstm_cell)


def _readout(params, carry, batch):
    return carry[2]


# the fused CUDA segment kernels are written for exactly this step
segment_fused.register_body(_body, "lstm")


def train_chain(cfg=None):
    """``ChainSpec`` for :func:`forward_loss`: one recurrence per chain step
    (the paper's §5 setup), carry ``(h, c, loss_acc)``, per-step inputs the
    (non-differentiated) token/target columns."""
    from repro_torch.api.chain import ChainSpec

    name = f"{cfg.name}-time" if cfg is not None else "lstm-time"
    return ChainSpec(_prelude, _body, _readout, name=name)
