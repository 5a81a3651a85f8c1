# Port of repro/api/chain.py over torch.utils._pytree.
"""Chain decomposition of a loss function.

The paper's machinery applies to any loss of the form

    carry_0, xs = prelude(params, batch)
    carry_{k+1} = body(params, carry_k, xs_k, batch)        k in [0, n)
    loss        = readout(params, carry_n, batch)

``ChainSpec`` captures that decomposition; the front-end
(``repro_torch.api.frontend``) differentiates through it with the
checkpointing executor instead of storing every carry.

Only ``params``, the carry, and the *inexact* (floating) leaves of ``xs``
are differentiated; ``batch`` and integer ``xs`` leaves (token ids) are
constants.  Gradients that flow out of the chain through ``carry_0`` and
``xs`` are pulled back through ``prelude`` by ordinary autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

Params = Any
Carry = Any
Batch = Any

PreludeFn = Callable[[Params, Batch], Tuple[Carry, Any]]
BodyFn = Callable[[Params, Carry, Any, Batch], Carry]
ReadoutFn = Callable[[Params, Carry, Batch], Any]


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """A loss expressed as prelude -> n x body -> readout.

    ``name`` doubles as the autotuner cache key component.  (The JAX
    package's per-layer fields for 2D plans come with the 2D planner,
    ROADMAP queue 1, item 11.)
    """

    prelude: PreludeFn
    body: BodyFn
    readout: ReadoutFn
    name: str = "chain"

    def loss_fn(self) -> Callable[[Params, Batch], Any]:
        """The undecomposed loss — reference semantics for the front-end
        (the function plain ``torch.autograd`` would differentiate)."""

        def loss(params, batch):
            carry, xs = self.prelude(params, batch)
            for k in range(chain_length(xs)):
                carry = self.body(params, carry, index_xs(xs, k), batch)
            return self.readout(params, carry, batch)

        return loss


def chain_length(xs: Any) -> int:
    """Number of chain steps — the (uniform) leading axis of ``xs``.

    >>> import torch
    >>> chain_length({"tok": torch.zeros((12, 4)), "tgt": torch.zeros((12,))})
    12
    """
    leaves = pytree.tree_leaves(xs)
    if not leaves:
        raise ValueError("chain xs must have at least one array leaf")
    ns = {int(leaf.shape[0]) for leaf in leaves}
    if len(ns) != 1:
        raise ValueError(f"inconsistent leading axes in chain xs: {ns}")
    return ns.pop()


def index_xs(xs: Any, k: int) -> Any:
    """Slice step ``k``'s per-step input out of stacked ``xs``."""
    return pytree.tree_map(lambda leaf: leaf[k], xs)


# ---------------------------------------------------------------------------
# inexact/nondiff partitioning (token ids ride along, but are not
# differentiated)
# ---------------------------------------------------------------------------


def is_inexact(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() or leaf.is_complex()
    return bool(np.issubdtype(np.asarray(leaf).dtype, np.inexact))


def diff_mask(tree: Any) -> Tuple[Any, Tuple[bool, ...]]:
    """(treespec, per-leaf inexact mask) for a pytree."""
    leaves, spec = pytree.tree_flatten(tree)
    return spec, tuple(is_inexact(leaf) for leaf in leaves)


def partition(tree: Any, mask: Tuple[bool, ...]):
    """Split flattened leaves into (diff_leaves, nondiff_leaves) lists."""
    leaves = pytree.tree_leaves(tree)
    diff = [leaf for leaf, m in zip(leaves, mask) if m]
    nondiff = [leaf for leaf, m in zip(leaves, mask) if not m]
    return diff, nondiff


def combine(diff, nondiff, treespec, mask: Tuple[bool, ...]) -> Any:
    """Inverse of :func:`partition`: re-interleave and unflatten."""
    diff_it, nondiff_it = iter(diff), iter(nondiff)
    leaves = [next(diff_it) if m else next(nondiff_it) for m in mask]
    return pytree.tree_unflatten(leaves, treespec)


def steps_vjp(body: BodyFn, params: Params, carry: Carry, xs: Any,
              batch: Batch, xs_mask: Tuple[bool, ...], dcarry: Carry, *,
              chunk: Optional[int] = None):
    """Vector-Jacobian product of the chain steps over ``xs`` (all of its
    leading axis) started from ``carry``, at the cotangent ``dcarry`` of
    the final carry.  Returns ``(dparams, dcarry_in, dxd)``: parameter and
    entry-carry cotangents with the structures of ``params``/``carry``,
    and one stacked cotangent per inexact ``xs`` leaf.  A parameter the
    steps do not read gets a broadcast (read-only) zero.

    ``chunk`` (the counterpart of the JAX engines' ``jax.checkpoint``
    regions) recomputes the steps under ``torch.utils.checkpoint`` in
    ``divmod(n, chunk)`` full chunks plus one shorter tail chunk, so only
    chunk-entry carries are kept while linearising."""
    p_leaves, p_spec = pytree.tree_flatten(params)
    c_leaves, c_spec = pytree.tree_flatten(carry)
    xs_spec = pytree.tree_structure(xs)
    xd, xnd = partition(xs, xs_mask)
    n = chain_length(xs)
    with torch.enable_grad():
        p_in = [t.detach().requires_grad_(is_inexact(t)) for t in p_leaves]
        c_in = [t.detach().requires_grad_(True) for t in c_leaves]
        xd_in = [t.detach().requires_grad_(True) for t in xd]
        params_v = pytree.tree_unflatten(p_in, p_spec)

        def run(lo, hi, *c_):
            c = pytree.tree_unflatten(list(c_), c_spec)
            for k in range(lo, hi):
                x = combine([leaf[k] for leaf in xd_in],
                            [leaf[k] for leaf in xnd], xs_spec, xs_mask)
                c = body(params_v, c, x, batch)
            return tuple(pytree.tree_leaves(c))

        if chunk is None or chunk >= n:
            out = run(0, n, *c_in)
        else:
            from torch.utils.checkpoint import checkpoint

            num_full, rem = divmod(n, chunk)
            out = tuple(c_in)
            for i in range(num_full):
                out = checkpoint(run, i * chunk, (i + 1) * chunk, *out,
                                 use_reentrant=False)
            if rem:
                out = checkpoint(run, num_full * chunk, n, *out,
                                 use_reentrant=False)
        dc_leaves = pytree.tree_leaves(dcarry)
        pairs = [(o, g) for o, g in zip(out, dc_leaves) if o.requires_grad]
        inputs = p_in + c_in + xd_in
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, grad_outputs=[g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
    n_p, n_c = len(p_in), len(c_in)
    full = []
    for i, t in enumerate(inputs):
        g = next(grads) if t.requires_grad else None
        if g is None:
            # a parameter the steps do not read (a depth chain reads its
            # weights from xs) gets a broadcast zero: no memory
            g = t.new_zeros(()).expand_as(t) if i < n_p \
                else torch.zeros_like(t)
        full.append(g)
    return (pytree.tree_unflatten(full[:n_p], p_spec),
            pytree.tree_unflatten(full[n_p:n_p + n_c], c_spec),
            full[n_p + n_c:])


def is_broadcast_zero(t: torch.Tensor) -> bool:
    """A zero that holds no memory of its own (``new_zeros(()).expand_as``):
    an accumulator leaf no gradient has reached yet, or the gradient of a
    parameter the steps do not read."""
    return t.dim() > 0 and all(s == 0 for s in t.stride())


def accumulate(gacc: Params, dp: Params) -> Params:
    """``gacc + dp`` leaf by leaf, added in place into accumulator leaves
    that hold memory.  A broadcast-zero accumulator leaf (as
    ``zero_grads`` makes them) takes a copy of its first real gradient, so
    a parameter the chain steps never read (a depth chain reads its
    stacked layers from ``xs``) never gets a gradient buffer here."""
    def add(acc, g):
        if is_broadcast_zero(g):
            return acc
        if is_broadcast_zero(acc):
            return g.clone()
        return acc.add_(g)

    return pytree.tree_map(add, gacc, dp)
