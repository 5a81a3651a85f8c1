# Port of repro/models/layers.py: the training-path building blocks.
"""Shared neural-net building blocks.

``dense``'s product, ``rmsnorm``, ``geglu``/``swiglu`` and ``apply_rope``
are autograd functions whose forward and backward launch hand-written
kernels on the card (``kernels/dense.py``, ``rmsnorm.py``, ``glu.py``,
``rope.py``) and run their plain PyTorch versions on any other device; the
rest is plain PyTorch (the loss head's products stay ``torch.matmul``).

Conventions, as in the JAX package:

* params are nested dicts of tensors; every module is an
  ``init_*(generator, ...) -> params`` / ``*(params, x, ...)`` pair.
* parameters are stored in ``param_dtype`` (fp32) and cast to
  ``compute_dtype`` (bf16) at use — the usual mixed-precision setup.
* stacked-layer parameters carry a leading layer axis, so depth is a loop
  over that axis (the JAX package's ``lax.scan``).

``init_*`` draw from a ``torch.Generator`` on the generator's own device
(a CUDA generator draws on the card, where full-width weights are made)
and place the result on ``device``.  ``apply_rope_at`` belongs to decode
and comes with it (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import build
from repro_torch.kernels import dense as dense_mod
from repro_torch.kernels import glu as glu_mod
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import rope as rope_mod

Params = Any


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DTypes:
    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16

    def c(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute)


DEFAULT_DTYPES = DTypes()


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def normal(generator: torch.Generator, shape, std: float, *, device,
           dtype=torch.float32) -> torch.Tensor:
    """``std``-scaled standard normals drawn on the generator's device,
    placed on ``device``."""
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=dtype)
    return t.mul_(std).to(device)


def zeros(shape, *, device, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def init_dense(generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, scale: Optional[float] = None,
               lead: Tuple[int, ...] = (), device=None) -> Params:
    """``lead``: leading stacked axes (the period axis of ``init_lm``)."""
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": normal(generator, (*lead, d_in, d_out), scale, device=device,
                     dtype=dtype)}
    if bias:
        p["b"] = zeros((*lead, d_out), device=device, dtype=dtype)
    return p


def dense(p: Params, x: torch.Tensor, dt: DTypes = DEFAULT_DTYPES,
          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` in the compute dtype, plus the bias: the product (with the
    weight's cast) in one kernel each way on the card.  ``residual``: a
    pre-norm layer's skip added to the result (``residual + y``), in the
    product's epilogue on the card where there is no bias."""
    if "b" in p:
        y = dense_mod.project(x, p["w"], dt.compute) + dt.c(p["b"])
        return y if residual is None else residual + y
    return dense_mod.project(x, p["w"], dt.compute, residual)


def init_rmsnorm(d: int, dtype=torch.float32, *, lead: Tuple[int, ...] = (),
                 device=None) -> Params:
    return {"scale": zeros((*lead, d), device=device, dtype=dtype)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6,
            dt: DTypes = DEFAULT_DTYPES,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gemma-style: normalise in fp32, weight stored as offset from 1, cast
    to the compute dtype; with ``residual``, ``residual + rmsnorm(x)`` (a
    post-norm's residual add, inside the same kernel on the card)."""
    return rn.rmsnorm_norm(x, p["scale"], eps=eps, out_dtype=dt.compute,
                           residual=residual)


def rmsnorm_fanout(p: Params, x: torch.Tensor, n: int = 1,
                   eps: float = 1e-6, dt: DTypes = DEFAULT_DTYPES
                   ) -> Tuple[torch.Tensor, ...]:
    """A pre-norm: ``(y, ..., y, skip)``, :func:`rmsnorm`'s ``y`` for each
    of ``n`` consumers (1 to 3) and ``x`` again as the residual's skip.  On
    the card the cotangents autograd would sum -- the consumers' and the
    skip's -- meet in the backward kernel; elsewhere the values are ``y``
    and ``x`` themselves, and autograd sums them."""
    return rn.rmsnorm_fanout(x, p["scale"], n, eps=eps,
                             out_dtype=dt.compute)


def init_embedding(generator, vocab: int, d: int, dtype=torch.float32, *,
                   device=None) -> Params:
    return {"emb": normal(generator, (vocab, d), d ** -0.5, device=device,
                          dtype=dtype)}


def embed(p: Params, tokens: torch.Tensor,
          dt: DTypes = DEFAULT_DTYPES, tied: bool = False) -> torch.Tensor:
    """The table's rows for ``tokens`` in the compute dtype.  ``tied``: the
    loss head reads the same table (:func:`head_table`), and the two
    gradients meet in one buffer (:class:`_TiedGather`)."""
    # gather, then cast: the JAX package's cast-then-gather gives the same
    # values without a compute-type copy of the whole table
    table, tokens = p["emb"], tokens.long()
    if tied and table.requires_grad and torch.is_grad_enabled():
        tie = _Tie()
        rows = _TiedGather.apply(table, tokens, tie)
        # weak: the node holds the tie, and a cycle would keep the graph
        tie.gather = weakref.ref(rows.grad_fn)
        _TIES[table] = tie
        return dt.c(rows)
    return dt.c(F.embedding(tokens, table))


def head_table(table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``table.to(dtype)`` for a loss head; if :func:`embed` gathered from
    this table with ``tied``, the head's gradient waits for the gather's,
    which adds its rows into it in place (:class:`_TiedGather`)."""
    tie = _TIES.pop(table, None)
    if tie is None or table.dtype == dtype or not torch.is_grad_enabled():
        return table.to(dtype)
    return _HeadCast.apply(table, dtype, tie)


class _Tie:
    """The head's gradient of a tied table (``grad``), handed to the
    gather's backward (``gather``, a weak reference to its node;
    ``gathered`` once it has run)."""

    def __init__(self):
        self.grad, self.gather, self.gathered = None, None, False


# a tied table -> the tie its last gather made, until the head takes it
_TIES = WeakIdKeyDictionary()


class _HeadCast(torch.autograd.Function):
    """``table.to(dtype)`` whose backward (``ToCopyBackward``'s cast of the
    cotangent) leaves the result to the tie when the gather's backward is
    still to run in this backward pass: autograd would otherwise hold it
    beside a second dense gradient of the table, the gather's, and add the
    two."""

    @staticmethod
    def forward(ctx, table, dtype, tie):
        ctx.src, ctx.tie = table.dtype, tie
        return table.to(dtype)

    @staticmethod
    def backward(ctx, g):
        grad, tie = g.to(ctx.src), ctx.tie
        gather = tie.gather()
        if (gather is None or tie.gathered
                or not torch._C._will_engine_execute_node(gather)):
            return grad, None, None
        tie.grad = grad
        return None, None, None


class _TiedGather(torch.autograd.Function):
    """``F.embedding(tokens, table)`` whose backward adds its rows into
    the head's gradient of the table in place, when the head left it in
    the tie: each token's rows summed as ``embedding_dense_backward`` sums
    them (on the distinct tokens, in the same order), then one add a
    distinct token, so the table's gradient is the one autograd's sum of
    the two dense gradients gives, with one dense buffer in place of
    two."""

    @staticmethod
    def forward(ctx, table, tokens, tie):
        ctx.save_for_backward(tokens)
        ctx.n, ctx.tie = table.shape[0], tie
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        tie = ctx.tie
        head, tie.grad, tie.gathered = tie.grad, None, True
        if head is None:
            return (torch.ops.aten.embedding_dense_backward(
                g, tokens, ctx.n, -1, False), None, None)
        uniq, inv = torch.unique(tokens, sorted=True, return_inverse=True)
        rows = torch.ops.aten.embedding_dense_backward(g, inv, uniq.numel(),
                                                       -1, False)
        head.index_put_((uniq,), head.index_select(0, uniq) + rows)
        return head, None, None


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return glu_mod.glu_act(gate, up, "silu")


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return glu_mod.glu_act(gate, up, "gelu")


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_table(seq_len: int, head_dim: int, theta: float = 10000.0,
               dtype=torch.float32, *, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin) of shape (seq_len, head_dim // 2)."""
    return rope_mod.rope_table_plain(seq_len, head_dim // 2, theta, device,
                                     dtype)


@dataclasses.dataclass(frozen=True)
class RopeAngles:
    """The rotary angles of positions ``0 .. S - 1`` by ``theta``, for a
    kernel that computes them itself (:func:`rope_angles`)."""
    theta: float


def rope_angles(seq_len: int, head_dim: int, theta: float = 10000.0, *,
                like: torch.Tensor):
    """What ``attention``'s ``rope`` takes for activations like ``like``:
    on the card :class:`RopeAngles` (the rope kernel computes
    :func:`rope_table`'s values itself, so no table is made), elsewhere
    :func:`rope_table` on ``like``'s device."""
    if build.on_card(like):
        return RopeAngles(float(theta))
    return rope_table(seq_len, head_dim, theta, device=like.device)


def rotate_qk(q: torch.Tensor, k: torch.Tensor, rope
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_rope`` of q and k by ``rope``: a ``(cos, sin)`` table or
    :class:`RopeAngles`."""
    if isinstance(rope, RopeAngles):
        return rope_mod.rope_apply_theta(rope.theta, q, k)
    return apply_rope_qk(q, k, *rope)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) — rotate-half convention."""
    return rope_mod.rope_apply(cos, sin, x)[0]


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_rope`` of q and k (one kernel launch on the card)."""
    return rope_mod.rope_apply(cos, sin, q, k)


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materialises full (B, S, V) logits)
# ---------------------------------------------------------------------------


def chunked_ce_loss(h: torch.Tensor, emb_w: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 512,
                    logit_cap: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross entropy over sequence chunks, so the full
    logits tensor (B, S, V) never exists.  ``emb_w``: (V, d) output
    embedding (possibly tied).  ``mask``: optional (B, S) validity mask.
    ``valid_vocab``: logical vocab when the table is padded — padded logits
    are masked out of the partition function.  A sequence length that does
    not divide into ``chunk`` gets a shorter remainder chunk.

    Memory: O(B * chunk * V).  Under autograd each chunk is recomputed in
    the backward (``torch.utils.checkpoint``), so its logits are not kept
    across chunks — the counterpart of XLA's scan, whose per-chunk
    residuals the JAX package leaves to the compiler.  Values are those of
    the plain loop.
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    num_full, rem = divmod(S, chunk)
    V = emb_w.shape[0]
    pad_mask = None
    if valid_vocab is not None and valid_vocab < V:
        pad_mask = torch.arange(V, device=h.device) < valid_vocab
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    wt = head_table(emb_w, h.dtype)

    def terms(hk, lk, mk):
        logits = hk @ wt.T  # (B, chunk, V)
        logits = softcap(logits.float(), logit_cap)
        if pad_mask is not None:
            logits = torch.where(pad_mask[None, None, :], logits,
                                 torch.full((), -1e30, device=h.device))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lk.long()[..., None])[..., 0]
        nll = (lse - gold) * mk
        return torch.sum(nll), torch.sum(mk)

    def run(hk, lk, mk):
        if torch.is_grad_enabled() and hk.requires_grad:
            return checkpoint(terms, hk, lk, mk, use_reentrant=False)
        return terms(hk, lk, mk)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(num_full):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = run(h[:, sl], labels[:, sl], mask[:, sl])
        tot, cnt = tot + t, cnt + c
    if rem:
        Sf = num_full * chunk
        t, c = run(h[:, Sf:], labels[:, Sf:], mask[:, Sf:])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_logits(h: torch.Tensor, emb_w: torch.Tensor,
              logit_cap: Optional[float] = None,
              valid_vocab: Optional[int] = None) -> torch.Tensor:
    logits = h @ emb_w.to(h.dtype).T
    logits = softcap(logits.float(), logit_cap)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits = logits[..., :valid_vocab]
    return logits
