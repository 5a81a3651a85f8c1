# Port of repro/analysis/jaxpr_cost.py: chain_step_byte_profile and the
# materialisation model it counts with (a torch dispatch mode in place of a
# jaxpr walk).
"""Per-step byte profile of a 2D-plannable chain.

The *materialisation model* (the JAX package's ``jaxpr_cost``): every
operation's output is counted as one write and one read of memory (2x its
bytes), except operations that only re-describe memory or copy it —
views, reshapes, transposes, slices, dtype casts, copies, detaches — and
constant fills (a broadcast constant in XLA).  It approximates the
activation bytes one step's reverse holds live to within a small factor.

The count runs on meta tensors under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode`: shapes only, so
no FLOP runs and no device memory is allocated.  An operation whose output
shape depends on the data cannot run on meta tensors and raises, naming
the operation.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.storage import tree_bytes

__all__ = ["chain_step_byte_profile", "op_bytes", "to_meta"]

aten = torch.ops.aten

# the JAX package's _VIEW_OPS and _FREE_OPS (jaxpr_cost.py:29-40) as aten
# operations: casts and copies (convert_element_type, copy), constant
# fills (broadcast_in_dim of a literal), detaches (stop_gradient) and
# re-described memory; every aten view (``OpOverload.is_view``) is free too
_FREE = {
    aten._to_copy, aten.clone, aten.copy_, aten.copy, aten.detach,
    aten.alias, aten.lift_fresh, aten.lift_fresh_copy, aten._unsafe_view,
    aten.full, aten.zeros, aten.ones, aten.empty, aten.empty_strided,
    aten.scalar_tensor, aten.full_like, aten.zeros_like, aten.ones_like,
    aten.empty_like, aten.new_full, aten.new_zeros, aten.new_ones,
    aten.new_empty, aten.fill_, aten.zero_, aten.expand_copy,
    aten.flip,   # rev
}


@functools.lru_cache(maxsize=None)
def _decompositions():
    from torch._decomp import core_aten_decompositions

    return dict(core_aten_decompositions().items())


def _out_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Adds 2x the output bytes of every counted operation to ``total``.
    An operation with a core ATen decomposition is counted through it (the
    JAX package's jaxpr holds primitives: its ``logsumexp`` is a max, a
    subtraction, an exponential and a sum)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        decomp = _decompositions().get(func)
        if decomp is not None:
            with self:
                out = decomp(*args, **(kwargs or {}))
            if out is not NotImplemented:
                return out
        try:
            out = func(*args, **(kwargs or {}))
        except (NotImplementedError, RuntimeError) as e:
            raise ValueError(
                f"the byte profile runs on tensor shapes only, and {func} "
                f"cannot: its result depends on the data ({e})") from e
        if not func.is_view and func.overloadpacket not in _FREE:
            self.total += 2 * _out_bytes(out)
        return out


def op_bytes(fn: Callable[..., Any], *args) -> Tuple[int, Any]:
    """``(bytes, fn(*args))``: the materialisation-model bytes of one call
    of ``fn``, run without autograd on whatever tensors ``args`` hold."""
    counter = _ByteCounter()
    with torch.no_grad(), counter:
        out = fn(*args)
    return counter.total, out


def to_meta(tree: Any) -> Any:
    """Shape/dtype stand-ins of a tree's tensors (other leaves as they
    are)."""
    return pytree.tree_map(
        lambda t: torch.empty_like(t, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def chain_step_byte_profile(spec, params, carry0, x0, batch):
    """Per-step byte profile of a 2D-plannable chain: what the inner DP
    (``schedule.gruslys_split`` through ``perfmodel.choose_2d_plan``)
    allocates against.

    Returns ``(state_bytes, layer_bytes, head_bytes)``:

    * ``state_bytes`` — one carry (an inner chunk-boundary state);
    * ``layer_bytes[j]`` — materialisation-model bytes of one
      ``spec.layer_body(..., j)`` application;
    * ``head_bytes`` — the ``spec.readout`` head's bytes (what head
      chunking divides).

    Shapes only: every layer runs once on meta stand-ins of the arguments,
    with the carry's shapes threaded from layer to layer.
    """
    p, c, x, b = (to_meta(t) for t in (params, carry0, x0, batch))
    state_bytes = tree_bytes(carry0)
    layer_bytes = []
    for j in range(spec.n_layers):
        nbytes, c = op_bytes(
            lambda pp, cc, xx, bb, j=j: spec.layer_body(pp, cc, xx, bb, j),
            p, c, x, b)
        layer_bytes.append(float(nbytes))
    head_bytes, _ = op_bytes(spec.readout, p, c, b)
    return state_bytes, tuple(layer_bytes), float(head_bytes)
