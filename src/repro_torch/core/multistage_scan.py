# Port of repro/core/multistage_scan.py: choose_interval, multistage_scan
# (interval=, plan=, s_l1=, nested_intervals=, uneven tails), _plan_groups,
# _run_groups, _make_segment and bptt_grad.
"""``multistage_scan`` — the paper's technique inside one autograd graph
(the engine behind ``engine="scan"`` in :mod:`repro_torch.api`).

A chain ``carry_{k+1} = body(carry_k, x_k)`` of length ``n`` is split into
the segments of a :class:`~repro_torch.core.schedule.SegmentPlan`, the same
plan the executor engines drive.  Each segment is one call of a
``torch.autograd.Function``:

* its forward runs the segment's steps without recording a graph and hands
  its entry carry to the segment policy
  (:class:`~repro_torch.core.offload.SegmentPolicy`), which copies it into
  page-locked host memory (Level 2) on a copy stream behind an event; the
  function keeps only that host copy, plus references to its parameters
  and per-step inputs;
* its backward pass takes its own boundary back (uploaded by the segment
  after it, one ahead), starts the upload of the previous segment's, and
  recomputes the segment with gradients on — the plan's inner chunks as a
  nested scan whose boundaries stay on the device — to return the
  cotangents of its entry carry and parameters.

Where the reference runs a ``lax.scan`` over a group of equal segments,
this runs a loop of segment calls.  Memory follows the paper's model:
Level 2 holds ``num_segments`` states, Level 1 one segment's activations
(constant in ``n``), and each segment interior is recomputed once.

Unlike ``jax.checkpoint``, an autograd function cannot see tensors that the
body reads from a closure: pass them as ``params=`` (the body is then
called as ``body(params, carry, x)``), or their gradients are lost.  The
per-step inputs' cotangents go into one full-chain buffer per
differentiable ``xs`` leaf, as the executor engines' do, so a stacked
parameter chain (a decoder's layers) gets one gradient tensor, not one a
segment.  ``jax.jit``, ``jax.vmap`` and mesh composition have no
counterpart here.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import offload as ofl
from repro_torch.core.schedule import SegmentPlan, segment_plan

Body = Callable[..., Tuple[Any, Any]]


def choose_interval(n: int, target: int) -> int:
    """Best Level-2 store interval <= ``target`` for an ``n``-step chain.

    Prefers the largest divisor of ``n`` in ``[ceil(target/2), target]``
    (even segments), but never degrades below half the requested interval:
    when no divisor is in range — prime or odd ``n`` — the target itself is
    returned and the plan simply ends in a shorter tail segment.

    >>> choose_interval(48, 10), choose_interval(41, 8)
    (8, 8)
    """
    target = max(1, min(target, n))
    floor = max(1, -(-target // 2))
    for i in range(target, floor - 1, -1):
        if n % i == 0:
            return i
    return target


def multistage_scan(
    body: Body,
    carry: Any,
    xs: Any = None,
    *,
    params: Any = None,
    length: Optional[int] = None,
    interval: Optional[int] = None,
    plan: Optional[SegmentPlan] = None,
    s_l1: Optional[int] = None,
    offload: bool = True,
    nested_intervals: Sequence[int] = (),
    boundary_name: str = ofl.BOUNDARY,
) -> Tuple[Any, Any]:
    """The chain ``carry, y_k = body(carry, x_k)`` over ``xs`` with
    asynchronous multistage checkpointing, driven by a
    :class:`~repro_torch.core.schedule.SegmentPlan`; differentiable with
    ``torch.autograd``.

    Args:
      body: ``(carry, x) -> (carry, y)``, or ``(params, carry, x) -> (carry,
        y)`` when ``params`` is given; ``y`` may be ``None``.
      carry: initial carry (a pytree of tensors: what gets offloaded).
      xs: stacked per-step inputs with leading axis ``n`` (or None).
      params: tensors the body reads besides the carry and ``xs`` (a
        pytree); gradients reach them only through this argument.
      length: chain length when ``xs is None``.
      interval: the checkpointing interval ``I``; a non-dividing interval
        gives a shorter tail segment.
      plan: an explicit :class:`SegmentPlan` (overrides ``interval`` and
        ``s_l1``; boundaries, the uneven tail and the inner recompute
        chunks come from the plan).
      s_l1: Level-1 snapshot budget: the plan is ``segment_plan(n,
        interval, s_l1)`` and segments that overflow it recompute in the
        plan's inner chunks.
      offload: boundaries go to Level 2 (page-locked host memory on the
        card) when True, else they stay where they are (plain segmented
        recompute).
      nested_intervals: explicit inner intervals for nested recompute
        inside each segment (ignored when ``plan``/``s_l1`` give them).

    Returns ``(final_carry, ys)``, the same as a plain loop, with the
    ``y_k`` stacked along a leading step axis (``None`` if the body
    returns none).
    """
    if xs is None:
        n = length
    else:
        n = int(pytree.tree_leaves(xs)[0].shape[0])
    if n is None:
        raise ValueError("need xs or length")

    if plan is not None:
        if plan.n != n:
            raise ValueError(
                f"plan is for an n={plan.n} chain, got xs of length {n}")
        groups = _plan_groups(plan)
    else:
        if interval is None:
            raise ValueError("need interval= or plan=")
        interval = max(1, min(interval, n))
        if s_l1 is not None:
            groups = _plan_groups(segment_plan(n, interval, s_l1))
        else:
            # uniform segments (+ an uneven tail), with the caller's
            # nested_intervals inside every segment
            nested = tuple(nested_intervals)
            num_full, tail = divmod(n, interval)
            groups = [(num_full, interval, nested)]
            if tail:
                groups.append((1, tail, nested))

    if params is None:
        def step(p, c, x):
            return body(c, x)
    else:
        step = body
    return _run_groups(step, params, carry, xs, groups, offload=offload,
                       boundary_name=boundary_name)


def _plan_groups(plan: SegmentPlan) -> List[Tuple[int, int, Tuple[int, ...]]]:
    """Collapse a plan into runs of equal-length segments: ``(count, length,
    nested_intervals)`` triples in forward order.  ``segment_plan`` emits
    uniform intervals plus at most one shorter tail.  The inner recompute
    interval is the plan's projection of its Revolve sub-plan
    (``SegmentPlan.inner_chunk``)."""
    groups: List[Tuple[int, int, Tuple[int, ...]]] = []
    for seg in plan.segments:
        chunk = plan.inner_chunk(seg)
        nested = (chunk,) if chunk is not None else ()
        if groups and groups[-1][1] == seg.length and \
                groups[-1][2] == nested:
            count, ln, nst = groups[-1]
            groups[-1] = (count + 1, ln, nst)
        else:
            groups.append((1, seg.length, nested))
    return groups


class _Run:
    """What the segments of one scan call share: the per-step inputs, the
    boundaries the policy keeps (by segment index), the full-chain
    cotangent buffers of the differentiable ``xs`` leaves, and the
    record."""

    def __init__(self, xs, policy: ofl.SegmentPolicy, record):
        self.xs_leaves, self.xs_spec = pytree.tree_flatten(xs)
        self.xs_diff = [i for i, t in enumerate(self.xs_leaves)
                        if t.requires_grad and t.is_floating_point()]
        self.policy = policy
        self.record = record
        self.boundaries: dict = {}
        self.dx: dict = {}   # xs leaf index -> full-chain cotangent

    def xs_slice(self, b: int, e: int, leaves=None):
        leaves = self.xs_leaves if leaves is None else leaves
        return pytree.tree_unflatten([t[b:e] for t in leaves], self.xs_spec)

    def keep_dx(self, i: int, b: int, g: torch.Tensor) -> None:
        full = self.dx.get(i)
        if full is None:
            full = self.dx[i] = torch.zeros_like(self.xs_leaves[i])
        full[b:b + g.shape[0]].copy_(g)


class _XsGrads(torch.autograd.Function):
    """The differentiable ``xs`` leaves enter the segments through one
    0-d token: each segment writes its slice's cotangents into the run's
    full-chain buffers, and this function's backward pass (after every
    segment's) returns those buffers."""

    @staticmethod
    def forward(ctx, run, *leaves):
        ctx.run = run
        return leaves[0].new_zeros(())

    @staticmethod
    def backward(ctx, _):
        run, ctx.run = ctx.run, None
        return (None, *(run.dx.pop(i, None) for i in run.xs_diff))


def _scan_steps(step, params, carry, xs, n: int):
    """The plain loop of ``n`` steps: ``(carry, stacked ys)``."""
    ys = []
    for k in range(n):
        x = None if xs is None else pytree.tree_map(lambda t: t[k], xs)
        carry, y = step(params, carry, x)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, pytree.tree_map(lambda *ts: torch.stack(ts), *ys)


class _Segment:
    """One segment of a run: its steps ``[begin, begin + length)``, its
    nested intervals, and the trees' structures."""

    def __init__(self, run: _Run, index: int, step, begin: int, length: int,
                 nested: Tuple[int, ...], p_spec, c_spec):
        self.run, self.index, self.step = run, index, step
        self.begin, self.length, self.nested = begin, length, nested
        self.p_spec, self.c_spec = p_spec, c_spec
        self.y_spec = None
        self.n_y = 0

    def xs(self, leaves=None):
        if not self.run.xs_leaves:
            return None
        return self.run.xs_slice(self.begin, self.begin + self.length,
                                 leaves)

    def recompute(self, params, carry, xs):
        """The segment with gradients on: the inner chunks as a nested scan
        whose boundaries stay in Level 1."""
        if not self.nested:
            return _scan_steps(self.step, params, carry, xs, self.length)
        inner_i, *rest = self.nested
        return multistage_scan(
            self.step, carry, xs, params=params,
            length=None if xs is not None else self.length,
            interval=min(inner_i, self.length), offload=False,
            nested_intervals=rest,
            boundary_name=ofl.INNER_BOUNDARY)


class _SegmentFn(torch.autograd.Function):
    """One segment: carry (and stacked ys) out, its entry carry kept by the
    run's policy; the backward pass recomputes it."""

    @staticmethod
    def forward(ctx, seg: _Segment, n_c: int, n_p: int, *inputs):
        c_leaves = list(inputs[:n_c])
        p_leaves = list(inputs[n_c:n_c + n_p])
        run = seg.run
        run.boundaries[seg.index] = run.policy.save(c_leaves, run.record)
        params = pytree.tree_unflatten(p_leaves, seg.p_spec)
        carry = pytree.tree_unflatten(c_leaves, seg.c_spec)
        carry, ys = _scan_steps(seg.step, params, carry, seg.xs(),
                                seg.length)
        out_c = pytree.tree_leaves(carry)
        y_leaves = []
        if ys is not None:
            y_leaves, seg.y_spec = pytree.tree_flatten(ys)
        seg.n_y = len(y_leaves)
        # an output must not be one of the inputs (a leaf the body passes
        # through): autograd would take it for the input itself
        ids = {id(t) for t in inputs}
        outs = [t.clone() if id(t) in ids else t for t in out_c + y_leaves]
        ctx.set_materialize_grads(False)
        ctx.seg, ctx.n_c, ctx.n_p = seg, n_c, n_p
        ctx.save_for_backward(*p_leaves)
        nondiff = [t for t in outs if not t.is_floating_point()]
        if nondiff:
            ctx.mark_non_differentiable(*nondiff)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        seg, n_c, n_p = ctx.seg, ctx.n_c, ctx.n_p
        run = seg.run
        ctx.seg = None
        c_saved = run.policy.load(run.boundaries.pop(seg.index), run.record)
        if seg.index > 0:   # the next backward pass's boundary, one ahead
            run.policy.prefetch(run.boundaries[seg.index - 1], run.record)
        need = ctx.needs_input_grad[3:]
        p_leaves = ctx.saved_tensors
        with torch.enable_grad():
            c_in = [t.detach().requires_grad_(need[i]
                                              and t.is_floating_point())
                    for i, t in enumerate(c_saved)]
            p_in = [t.detach().requires_grad_(need[n_c + i]
                                              and t.is_floating_point())
                    for i, t in enumerate(p_leaves)]
            x_all = [t.detach() for t in run.xs_leaves]
            for i in run.xs_diff:
                x_all[i] = x_all[i][seg.begin:seg.begin + seg.length] \
                    .requires_grad_(True)
            x_in = [t if i in run.xs_diff
                    else t[seg.begin:seg.begin + seg.length]
                    for i, t in enumerate(x_all)]
            xs = None if not x_in else \
                pytree.tree_unflatten(x_in, run.xs_spec)
            carry, ys = seg.recompute(
                pytree.tree_unflatten(p_in, seg.p_spec),
                pytree.tree_unflatten(c_in, seg.c_spec), xs)
            outs = pytree.tree_leaves(carry)
            if ys is not None:
                outs += pytree.tree_leaves(ys)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wanted = [t for t in c_in + p_in if t.requires_grad] + \
                [x_in[i] for i in run.xs_diff]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted,
                grad_outputs=[g for _, g in pairs], allow_unused=True)
                if pairs else [None] * len(wanted))
        out = [next(got) if t.requires_grad else None for t in c_in + p_in]
        for i in run.xs_diff:
            g = next(got)
            if g is not None:
                run.keep_dx(i, seg.begin, g)
        token = []
        if run.xs_diff:
            token = [torch.zeros((), device=c_saved[0].device)]
        return (None, None, None, *out, *token)


def _run_groups(step, params, carry, xs, groups, *, offload: bool,
                boundary_name: str) -> Tuple[Any, Any]:
    """Execute ``(count, length, nested)`` segment groups in order, one
    segment call at a time."""
    record = ofl.ScanRecord()
    run = _Run(xs, ofl.SegmentPolicy(offload), record)
    token = []
    if run.xs_diff:
        token = [_XsGrads.apply(run, *(run.xs_leaves[i]
                                       for i in run.xs_diff))]
    ys_parts: List[Any] = []
    begin = 0
    for count, seg_len, nested in groups:
        for _ in range(count):
            segment = _make_segment(run, len(ys_parts), step, begin,
                                    seg_len, tuple(nested))
            carry, ys = segment(params, carry, token)
            ys_parts.append(ys)
            begin += seg_len
    record.segments = len(ys_parts)
    if boundary_name == ofl.BOUNDARY:
        ofl.publish(record)
    if any(y is None for y in ys_parts):
        return carry, None
    if len(ys_parts) == 1:
        return carry, ys_parts[0]
    return carry, pytree.tree_map(lambda *ps: torch.cat(ps), *ys_parts)


def _make_segment(run: _Run, index: int, step, begin: int, seg_len: int,
                  nested: Tuple[int, ...]):
    """Segment ``index`` of ``run`` (steps ``[begin, begin + seg_len)``) as
    a function ``(params, carry, token) -> (carry, ys)``: one call of the
    segment's autograd function, whose entry carry the run's policy
    keeps."""

    def segment(params, carry, token):
        p_leaves, p_spec = pytree.tree_flatten(params)
        c_leaves, c_spec = pytree.tree_flatten(carry)
        seg = _Segment(run, index, step, begin, seg_len, nested, p_spec,
                       c_spec)
        outs = _SegmentFn.apply(seg, len(c_leaves), len(p_leaves),
                                *c_leaves, *p_leaves, *token)
        carry = pytree.tree_unflatten(list(outs[:len(c_leaves)]), c_spec)
        if seg.y_spec is None or not seg.n_y:
            return carry, None
        return carry, pytree.tree_unflatten(list(outs[len(c_leaves):]),
                                            seg.y_spec)

    return segment


# ---------------------------------------------------------------------------
# BPTT convenience wrapper
# ---------------------------------------------------------------------------


def bptt_grad(
    step_loss: Callable[[Any, Any, Any], Tuple[Any, Any]],
    params: Any,
    carry0: Any,
    xs: Any,
    *,
    interval: int,
    s_l1: Optional[int] = None,
    offload: bool = True,
    nested_intervals: Sequence[int] = (),
) -> Tuple[Any, Any]:
    """Gradient of a summed per-step loss over a long sequence, computed with
    multistage checkpointing.

    ``step_loss(params, carry, x) -> (new_carry, loss_k)``.

    Returns ``(total_loss, grads)`` — the multistage counterpart of
    ``torch.autograd`` over a plain step loop.

    >>> import torch
    >>> def step_loss(p, c, x):
    ...     c = torch.tanh(c * p + x)
    ...     return c, (c ** 2).sum()
    >>> xs = torch.linspace(-1.0, 1.0, 10)
    >>> v, g = bptt_grad(step_loss, torch.tensor(0.7), torch.tensor(0.0), xs,
    ...                  interval=4)
    >>> p = torch.tensor(0.7, requires_grad=True)
    >>> c, ref = torch.tensor(0.0), 0.0
    >>> for x in xs:
    ...     c, l_k = step_loss(p, c, x)
    ...     ref = ref + l_k
    >>> bool(torch.allclose(v, ref)), bool(torch.allclose(
    ...     g, torch.autograd.grad(ref, p)[0]))
    (True, True)
    """
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        p = pytree.tree_unflatten(leaves, spec)
        _, losses = multistage_scan(
            step_loss, carry0, xs, params=p, interval=interval, s_l1=s_l1,
            offload=offload, nested_intervals=nested_intervals)
        total = losses.sum()
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return total.detach(), pytree.tree_unflatten(grads, spec)
