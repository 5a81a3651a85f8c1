# Port of repro/api/frontend.py: OffloadConfig, value_and_grad_offloaded
# (engine="compiled", strategy="multistage_async", storage="ram") and
# last_stats/last_tune/last_plan.
"""Drop-in autodiff front-end for asynchronous multistage checkpointing.

``value_and_grad_offloaded(loss)`` is the paper's technique packaged the way
a ``value_and_grad`` is: hand it a loss, get back a function returning
``(loss, grads)``.  The difference is *how* the backward pass runs:

* the forward chain executes one segment runner call per interval while
  the ``AsyncTransferEngine`` streams every ``I``-th carry to Level-2 host
  RAM on a background thread;
* the backward pass replays segments from Level 2 with double-buffered
  prefetch, each reversed by one runner call — peak Level-1 memory is
  ``O(I + s)``, independent of chain length, at a constant recompute
  factor and O(n/I) host dispatches.

Mechanically this is a ``torch.autograd.Function``: its forward runs the
executor's forward sweep and keeps the in-flight run on the context, its
backward runs the reverse sweep from the readout's cotangent.  Gradients
of the prelude and readout flow through ordinary autograd around it.

``runner="fused"`` (the JAX package's ``runner="pallas"``) drives the
hand-written CUDA segment kernels; ``runner="compiled"`` is plain PyTorch,
as XLA's is in JAX.  The schedule ``(I, s)`` is measured on the first call
(``I = ceil(T_T/T_A)``, §3) unless ``interval=`` pins it.

Everything runs on the card unless ``device="cpu"`` is passed.  Not ported
yet, and raising ``NotImplementedError`` when asked for: the Revolve and
conventional strategies and the interpreted engine (ROADMAP queue 1,
item 4), storage kinds other than ``"ram"`` (item 9), journaling (item 8),
meshes (item 15), 2D plans (item 11), parameter streaming (item 12) and the
scan engine (item 13).
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.api import autotune as at
from repro_torch.api.chain import (ChainSpec, chain_length, combine,
                                   diff_mask, is_inexact, partition)
from repro_torch.core import schedule as ms
from repro_torch.core.compiled_ops import (CompiledChainOps,
                                           CompiledSegmentRunner,
                                           FusedSegmentRunner)
from repro_torch.core.executor import CheckpointExecutor, ExecutionStats
from repro_torch.core.storage import (AsyncTransferEngine, RAMStorage,
                                      _to_host)
from repro_torch.device import resolve_device
from repro_torch.kernels import segment_fused

STRATEGIES = ("multistage_async", "revolve", "conventional")
ENGINES = ("compiled", "interpreted", "scan")
RUNNERS = ("compiled", "fused")
STORAGE_KINDS = ("ram", "disk", "compressed", "tiered")


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Static (hashable) knobs of one offloaded-gradient transform."""

    strategy: str = "multistage_async"
    interval: Optional[int] = None    # None -> autotune (I = ceil(T_T/T_A))
    slots: Optional[int] = None       # Level-1 slots; None -> budget
    storage: str = "ram"
    autotune: bool = True
    tuner_id: int = 0                 # key into the tuner registry
    engine: str = "compiled"
    runner: str = "compiled"          # "compiled" (plain PyTorch per
    #                                   segment) | "fused" (CUDA kernels)

    def __post_init__(self):
        # the JAX package's ValueErrors for these knobs, in its order
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; known: {STRATEGIES}")
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; known: {ENGINES}")
        if self.runner not in RUNNERS:
            raise ValueError(
                f"unknown runner {self.runner!r}; known: {RUNNERS}")
        if self.runner == "fused" and self.engine != "compiled":
            raise ValueError(
                "runner='fused' fuses the compiled engine's per-segment "
                f"steps into CUDA kernels; engine={self.engine!r} does not "
                "use segment runners")
        if self.engine == "scan":
            if self.strategy != "multistage_async":
                raise ValueError(
                    "engine='scan' implements the multistage_async strategy "
                    f"only, got strategy={self.strategy!r}")
            if self.storage != "ram":
                raise ValueError(
                    "engine='scan' keeps Level-2 state in host memory of its "
                    f"own; the pluggable storage backends "
                    f"({STORAGE_KINDS[1:]}) apply to the executor engines "
                    "only")
        if self.storage not in STORAGE_KINDS:
            raise ValueError(
                f"unknown Level-2 backend {self.storage!r}; known: "
                f"{STORAGE_KINDS}")
        # valid, but not ported yet
        if self.strategy != "multistage_async":
            raise NotImplementedError(
                f"strategy={self.strategy!r} is not ported yet (ROADMAP "
                "queue 1, item 4)")
        if self.engine == "interpreted":
            raise NotImplementedError(
                "engine='interpreted' is not ported yet (ROADMAP queue 1, "
                "item 4)")
        if self.engine == "scan":
            raise NotImplementedError(
                "engine='scan' is not ported yet (ROADMAP queue 1, item 13)")
        if self.storage != "ram":
            raise NotImplementedError(
                f"storage={self.storage!r} is not ported yet (ROADMAP "
                "queue 1, item 9)")


@dataclasses.dataclass(frozen=True)
class _Static:
    """What the autograd Function needs besides tensors."""

    spec: ChainSpec
    cfg: OffloadConfig
    xs_treespec: Any
    xs_mask: Tuple[bool, ...]


# ---------------------------------------------------------------------------
# tuner registry, last-run records
# ---------------------------------------------------------------------------

_TUNERS: "weakref.WeakValueDictionary[int, at.AutoTuner]" = \
    weakref.WeakValueDictionary({0: at.GLOBAL_TUNER})
_TUNER_IDS = itertools.count(1)


def _register_tuner(tuner: Optional[at.AutoTuner]) -> int:
    if tuner is None or tuner is at.GLOBAL_TUNER:
        return 0
    tid = next(_TUNER_IDS)
    _TUNERS[tid] = tuner
    return tid


_LAST: Dict[str, Any] = {"stats": None, "tune": None, "plan": None}


def last_stats() -> Optional[ExecutionStats]:
    """ExecutionStats of the most recent offloaded backward pass."""
    return _LAST["stats"]


def last_tune() -> Optional[at.TuneResult]:
    """The schedule chosen for the most recent forward pass."""
    return _LAST["tune"]


def last_plan() -> Optional[ms.SegmentPlan]:
    """The :class:`~repro_torch.core.schedule.SegmentPlan` behind the most
    recent forward pass."""
    return _LAST["plan"]


# Copy of repro/core/multistage_scan.py::choose_interval.
def choose_interval(n: int, target: int) -> int:
    """Best Level-2 store interval <= ``target`` for an ``n``-step chain:
    the largest divisor of ``n`` in ``[ceil(target/2), target]``, else the
    target itself (the plan then ends in a shorter tail segment)."""
    target = max(1, min(target, n))
    floor = max(1, -(-target // 2))
    for i in range(target, floor - 1, -1):
        if n % i == 0:
            return i
    return target


def _resolve_schedule(static: _Static, ops: CompiledChainOps, params, carry0,
                      xs, batch, n: int, backend) -> at.TuneResult:
    cfg = static.cfg
    tuner = _TUNERS.get(cfg.tuner_id, at.GLOBAL_TUNER)
    if cfg.interval is not None:
        return tuner.manual(static.spec.name, n=n, interval=cfg.interval,
                            slots=cfg.slots)
    if not cfg.autotune:
        return tuner.manual(static.spec.name, n=n,
                            interval=max(1, min(n, 32)), slots=cfg.slots)
    # T_A depends on the segment runner: it is part of the cache identity
    tune_name = f"{static.spec.name}:{cfg.engine}"
    if cfg.runner == "fused":
        tune_name += ":fused"
    # T_A is the amortised per-step time of a segment: probe one advance
    # over a short prefix whose length is a snap candidate of n
    cap = max(1, min(n, 32))
    cand = choose_interval(n, cap)
    probe_len = cand if cand >= min(cap, 8) else cap
    xs_probe = pytree.tree_map(lambda leaf: leaf[:probe_len].contiguous(), xs)
    store_state0 = None
    if cfg.runner == "fused":
        # probe the fused path: T_A includes the in-kernel boundary copy,
        # and T_T is a store of a host-resident state, because the kernel
        # has already written the boundary to host memory
        def forward_segment(state):
            return segment_fused.fused_advance_segment(
                ops.body, params, state, xs_probe, batch,
                chunk=probe_len).carry

        store_state0 = _to_host(carry0)
    else:
        def forward_segment(state):
            return ops.advance_segment(params, state, xs_probe, batch)

    tune = tuner.measure(tune_name, forward_segment=forward_segment,
                         segment_len=probe_len, state0=carry0, n=n,
                         backend=backend, store_state0=store_state0)
    if cfg.slots is not None:
        tune = dataclasses.replace(tune, slots=cfg.slots)
    return tune


class _RunRecord:
    """The in-flight run between the two sweeps; closes it if the backward
    pass never comes."""

    def __init__(self, run):
        self.run = run

    def dispose(self) -> None:
        if self.run is not None:
            run, self.run = self.run, None
            try:
                run.close()
            except Exception:
                pass

    def __del__(self):
        self.dispose()


def _fwd(static: _Static, params, carry0, xs, batch):
    spec, cfg = static.spec, static.cfg
    n = chain_length(xs)
    ops = CompiledChainOps(spec.body, static.xs_treespec, static.xs_mask)
    backend = RAMStorage()
    device = pytree.tree_leaves(carry0)[0].device
    engine = None
    if cfg.runner == "fused":
        segment_fused.check_token_range(spec.body, params, xs)
    try:
        tune = _resolve_schedule(static, ops, params, carry0, xs, batch, n,
                                 backend)
        engine = AsyncTransferEngine(backend, device=device)
        runner_cls = FusedSegmentRunner if cfg.runner == "fused" \
            else CompiledSegmentRunner
        runner = runner_cls(ops, params, xs, batch, s_l1=tune.slots)
        x_n, run = CheckpointExecutor().multistage_forward(
            carry0, n, interval=tune.interval, s_l1=tune.slots,
            engine=engine, runner=runner)
    except BaseException:
        if engine is not None:
            try:
                engine.close()
            except Exception:
                pass
        raise
    run.own_engine = True
    _LAST["plan"] = run.plan
    _LAST["tune"] = tune
    return x_n, _RunRecord(run)


def _bwd(static: _Static, rec: _RunRecord, params, dcarry):
    run = rec.run
    if run is None:
        raise RuntimeError("offloaded-chain run is no longer live (backward "
                           "called twice?); re-run the forward pass")
    adjoint0 = (dcarry, pytree.tree_map(torch.zeros_like, params))
    try:
        adjoint, stats = CheckpointExecutor().multistage_reverse(run,
                                                                 adjoint0)
    finally:
        rec.dispose()   # idempotent: the reverse already closed the run
    _LAST["stats"] = stats
    dcarry0, gparams = adjoint
    dxs_diff = run.runner.collect_dx(run.plan) if any(static.xs_mask) else []
    return gparams, dcarry0, dxs_diff


class _Chain(torch.autograd.Function):
    """carry_n = the chain over xs from carry_0; differentiable in the
    params, carry_0 and the inexact xs leaves (flattened into ``leaves``)."""

    @staticmethod
    def forward(ctx, static, meta, *leaves):
        p_spec, c_spec, n_p, n_c, xnd, batch = meta
        params = pytree.tree_unflatten(list(leaves[:n_p]), p_spec)
        carry0 = pytree.tree_unflatten(list(leaves[n_p:n_p + n_c]), c_spec)
        xs = combine(list(leaves[n_p + n_c:]), xnd, static.xs_treespec,
                     static.xs_mask)
        x_n, rec = _fwd(static, params, carry0, xs, batch)
        ctx.static, ctx.rec, ctx.params, ctx.c_spec = static, rec, params, \
            c_spec
        return tuple(pytree.tree_leaves(x_n))

    @staticmethod
    def backward(ctx, *dcarry_leaves):
        dcarry = pytree.tree_unflatten(list(dcarry_leaves), ctx.c_spec)
        gparams, dcarry0, dxs_diff = _bwd(ctx.static, ctx.rec, ctx.params,
                                          dcarry)
        return (None, None, *pytree.tree_leaves(gparams),
                *pytree.tree_leaves(dcarry0), *dxs_diff)


def _chain(static: _Static, params, carry0, xs, batch):
    p_leaves, p_spec = pytree.tree_flatten(params)
    c_leaves, c_spec = pytree.tree_flatten(carry0)
    for leaf in c_leaves:
        if not is_inexact(leaf):
            raise TypeError(
                "chain carry leaves must be inexact (float) tensors; fold "
                "integer state into xs/batch instead")
    xd, xnd = partition(xs, static.xs_mask)
    meta = (p_spec, c_spec, len(p_leaves), len(c_leaves), xnd, batch)
    out = _Chain.apply(static, meta, *p_leaves, *c_leaves, *xd)
    return pytree.tree_unflatten(list(out), c_spec)


def offloaded_loss(spec: ChainSpec, cfg: OffloadConfig
                   ) -> Callable[[Any, Any], Any]:
    """The loss with its chain segment rerouted through the executor;
    differentiable with ``torch.autograd``."""

    def loss(params, batch):
        carry0, xs = spec.prelude(params, batch)
        treespec, mask = diff_mask(xs)
        static = _Static(spec=spec, cfg=cfg, xs_treespec=treespec,
                         xs_mask=mask)
        carry_n = _chain(static, params, carry0, xs, batch)
        return spec.readout(params, carry_n, batch)

    return loss


def _as_chain_spec(loss_fn) -> Optional[ChainSpec]:
    if isinstance(loss_fn, ChainSpec):
        return loss_fn
    return getattr(loss_fn, "chain_spec", None)


def _to_device(tree, device):
    return pytree.tree_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor)
        else torch.as_tensor(np.asarray(a), device=device), tree)


def _value_and_grad(loss, device):
    def vg(params, batch):
        params = _to_device(params, device)
        batch = _to_device(batch, device)
        leaves, p_spec = pytree.tree_flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            value = loss(pytree.tree_unflatten(leaves, p_spec), batch)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return value.detach(), pytree.tree_unflatten(grads, p_spec)

    return vg


def value_and_grad_offloaded(
    loss_fn,
    *,
    strategy: str = "multistage_async",
    interval: Optional[int] = None,
    slots: Optional[int] = None,
    storage: str = "ram",
    autotune: bool = True,
    tuner: Optional[at.AutoTuner] = None,
    fallback: bool = True,
    engine: str = "compiled",
    runner: str = "compiled",
    device=None,
) -> Callable[[Any, Any], Tuple[Any, Any]]:
    """Drop-in ``value_and_grad`` with multistage-offloaded backprop.

    ``loss_fn`` is a :class:`ChainSpec`, or a callable carrying one as a
    ``chain_spec`` attribute (the model factory attaches these).  A plain
    callable with no chain structure falls back to ordinary autograd when
    ``fallback=True`` (with a warning).

    Returns ``f(params, batch) -> (loss, grads)``, running on ``device``
    (the card unless ``device="cpu"``; without a card and without
    ``device="cpu"`` this raises).  ``interval``/``slots`` pin the schedule,
    otherwise the first call measures ``T_A``/``T_T`` and applies §3's
    ``I = ceil(T_T/T_A)``.  ``runner="fused"`` (the JAX package's
    ``runner="pallas"``) runs the hand-written CUDA segment kernels on the
    card — the LSTM chain step only; other chains raise ``ValueError`` there
    — and their plain PyTorch versions on the CPU.

    >>> import torch
    >>> from repro_torch.api import ChainSpec, value_and_grad_offloaded
    >>> spec = ChainSpec(
    ...     prelude=lambda p, b: (torch.zeros(()), b["xs"]),
    ...     body=lambda p, c, x, b: c + p["w"] * torch.tanh(x + c),
    ...     readout=lambda p, c, b: c, name="doc-vg-chain")
    >>> vg = value_and_grad_offloaded(spec, interval=4, slots=2, device="cpu")
    >>> loss, grads = vg({"w": torch.tensor(0.5)},
    ...                  {"xs": torch.linspace(-1.0, 1.0, 8)})
    >>> tuple(grads["w"].shape)
    ()
    """
    dev = resolve_device(device)
    spec = _as_chain_spec(loss_fn)
    if spec is None:
        if not fallback:
            raise TypeError(
                "loss_fn has no chain decomposition (expected a ChainSpec "
                "or a callable with a .chain_spec attribute)")
        warnings.warn(
            "value_and_grad_offloaded: loss has no chain decomposition; "
            "falling back to plain autograd (no offloading)", stacklevel=2)
        return _value_and_grad(loss_fn, dev)
    cfg = OffloadConfig(strategy=strategy, interval=interval, slots=slots,
                        storage=storage, autotune=autotune,
                        tuner_id=_register_tuner(tuner), engine=engine,
                        runner=runner)
    vg = _value_and_grad(offloaded_loss(spec, cfg), dev)
    vg.chain_spec = spec
    vg.offload_config = cfg
    vg.tuner = tuner  # keeps the weak registry entry alive
    vg.device = dev
    return vg
