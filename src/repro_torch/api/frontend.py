# Port of repro/api/frontend.py: OffloadConfig, value_and_grad_offloaded
# (strategies multistage_async, revolve and conventional; engines compiled
# and interpreted; the storage kinds of the backend registry and backend=;
# journal_dir=/resume=/journal_repair=), _make_backend, _input_fingerprint,
# resume_offloaded, checkpointed_bptt and last_stats/last_tune/last_plan.
"""Drop-in autodiff front-end for asynchronous multistage checkpointing.

``value_and_grad_offloaded(loss)`` is the paper's technique packaged the way
a ``value_and_grad`` is: hand it a loss, get back a function returning
``(loss, grads)``.  The difference is *how* the backward pass runs:

* the forward chain executes one segment runner call per interval while
  the ``AsyncTransferEngine`` streams every ``I``-th carry to Level 2 (host
  RAM, disk, int8-compressed or a capacity-bounded tier over disk) on a
  background thread;
* the backward pass replays segments from Level 2 with double-buffered
  prefetch, each reversed by one runner call — peak Level-1 memory is
  ``O(I + s)``, independent of chain length, at a constant recompute
  factor and O(n/I) host dispatches (``engine="interpreted"`` walks the
  same plan one step per dispatch, the paper-faithful interpreter).

``strategy="revolve"`` and ``strategy="conventional"`` are the paper's
baselines: the forward computes ``x_n`` without storing anything, and the
backward pass runs classic Revolve with ``s`` Level-1 slots, or stores every
state, over per-step operators.

Mechanically this is a ``torch.autograd.Function``: its forward runs the
executor's forward sweep and keeps the in-flight run on the context, its
backward runs the reverse sweep from the readout's cotangent.  Gradients
of the prelude and readout flow through ordinary autograd around it.

``runner="fused"`` (the JAX package's ``runner="pallas"``) drives the
hand-written CUDA segment kernels; ``runner="compiled"`` is plain PyTorch,
as XLA's is in JAX.  The schedule ``(I, s)`` is measured on the first call
(``I = ceil(T_T/T_A)``, §3) unless ``interval=`` pins it.

``journal_dir=`` makes a multistage run crash-consistent (a write-ahead
journal of every Level-2 store, delete and segment cursor), and
``resume_offloaded`` finishes a crashed gradient from that journal, bit for
bit, replaying at most one interval.

Everything runs on the card unless ``device="cpu"`` is passed.  Not ported
yet, and raising ``NotImplementedError`` when asked for: meshes (ROADMAP
queue 1, item 15), 2D plans (item 11), parameter streaming (item 12) and
the scan engine (item 13).
"""
from __future__ import annotations

import dataclasses
import itertools
import shutil
import tempfile
import warnings
import weakref
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.api import autotune as at
from repro_torch.api.chain import (ChainSpec, accumulate, chain_length,
                                   combine, diff_mask, index_xs, is_inexact,
                                   is_broadcast_zero, partition, steps_vjp)
from repro_torch.core import schedule as ms
from repro_torch.core.compiled_ops import (CompiledChainOps,
                                           CompiledSegmentRunner,
                                           FusedSegmentRunner)
from repro_torch.core.executor import (CheckpointExecutor, ExecutionStats,
                                       placed)
from repro_torch.core.storage import (AsyncTransferEngine, HostTree,
                                      JournaledStorage, make_backend)
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
    storage: str = "ram"              # a kind of the backend registry:
    #                                   "ram" | "disk" | "compressed" |
    #                                   "tiered" | any register_backend()'d
    storage_dir: Optional[str] = None
    l2_capacity_bytes: Optional[int] = None  # fast-tier budget ("tiered")
    journal_dir: Optional[str] = None  # crash-consistency WAL directory
    resume: bool = False              # resume a crashed run from the journal
    journal_repair: bool = False      # truncate a CRC-damaged journal on open
    autotune: bool = True
    tuner_id: int = 0                 # key into the tuner registry
    backend_id: int = 0               # key into the shared-backend registry
    #                                   (0: build one from ``storage``;
    #                                   else the caller's backend=)
    engine: str = "compiled"
    runner: str = "compiled"          # "compiled" (plain PyTorch per
    #                                   segment) | "fused" (CUDA kernels)
    # knobs of the JAX package that are not ported yet (each raises)
    mesh: Optional[Any] = None
    step_memory_budget: Optional[int] = None
    plan_2d: Optional[Tuple[int, int]] = None
    offload_params: Optional[str] = None

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
        if self.storage == "tiered" and self.l2_capacity_bytes is None:
            raise ValueError(
                "storage='tiered' needs l2_capacity_bytes= (the fast-tier "
                "budget the Level-2 store must stay under)")
        if self.l2_capacity_bytes is not None and self.storage != "tiered":
            raise ValueError(
                "l2_capacity_bytes only applies to storage='tiered' "
                f"(got storage={self.storage!r}); the unbounded backends "
                "have no budget to enforce")
        if self.backend_id and self.mesh is not None:
            raise ValueError(
                "backend= hands the transform one already-built Level-2 "
                "store; sharded per-device streams (mesh=) must be built "
                "from a storage kind instead")
        if self.resume and self.journal_dir is None:
            raise ValueError(
                "resume=True needs journal_dir= (there is nothing to "
                "recover without a write-ahead journal)")
        if self.journal_dir is not None and \
                self.strategy != "multistage_async":
            raise ValueError(
                "journal_dir= journals the Level-2 boundary stores of the "
                "multistage_async strategy; strategy="
                f"{self.strategy!r} keeps no Level-2 state to journal")
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
            if self.journal_dir is not None:
                raise ValueError(
                    "engine='scan' runs as one traced program — its Level-2 "
                    "state cannot be journaled; use the executor engines "
                    "('compiled'/'interpreted') for crash consistency")
        # valid, but not ported yet; an unknown storage kind raises at the
        # first call, from the backend registry (as in the JAX package)
        for given, what, item in (
                (self.engine == "scan", "engine='scan'", 13),
                (self.mesh is not None, "mesh=", 15),
                (self.step_memory_budget is not None
                 or self.plan_2d is not None,
                 "2D plans (step_memory_budget=/plan_2d=)", 11),
                (self.offload_params is not None, "offload_params=", 12)):
            if given:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP queue 1, item "
                    f"{item})")


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


# The same weak registry for caller-supplied Level-2 backends: the config
# stays a hashable frozen dataclass carrying only the id, and the transform
# keeps the backend alive (``vg.backend``) for as long as it can be called.
_SHARED_BACKENDS: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()
_SHARED_BACKEND_IDS = itertools.count(1)


def _register_shared_backend(backend: Optional[Any]) -> int:
    if backend is None:
        return 0
    bid = next(_SHARED_BACKEND_IDS)
    _SHARED_BACKENDS[bid] = backend
    return bid


def _make_backend(cfg: OffloadConfig):
    """The run's Level-2 backend, from the registry
    (:func:`~repro_torch.core.storage.make_backend`: an unknown kind raises
    there, and kinds added with ``register_backend`` work here), or the
    caller's ``backend=``; with ``journal_dir`` a
    :class:`~repro_torch.core.storage.JournaledStorage` over it.  Returns
    ``(backend, tmpdir)``: ``tmpdir`` is a directory made here for the slow
    tier, removed when the run is disposed of."""
    if cfg.backend_id:
        backend = _SHARED_BACKENDS.get(cfg.backend_id)
        if backend is None:
            raise ValueError(
                "the backend= object this transform was built over is no "
                "longer alive; hold a reference to the transform (or the "
                "backend) for as long as it is called")
        if cfg.journal_dir is not None:
            # Journal composes OUTSIDE the shared store: the WAL records the
            # run's raw (un-namespaced) keys, so a resume replays into
            # whatever namespace the new backend view carries.
            backend = JournaledStorage(backend, cfg.journal_dir,
                                       repair=cfg.journal_repair)
        return backend, None
    tmpdir = None
    kwargs = {}
    if cfg.storage in ("disk", "tiered") or (
            cfg.storage == "compressed" and cfg.storage_dir is not None):
        # a tiered store's slow tier is the disk unless the caller pinned
        # a directory
        directory = cfg.storage_dir
        if directory is None:
            directory = tmpdir = tempfile.mkdtemp(prefix="repro_l2_")
        kwargs["directory"] = directory
    if cfg.storage == "tiered":
        kwargs["capacity_bytes"] = cfg.l2_capacity_bytes
    if cfg.journal_dir is not None:
        kwargs["journal"] = cfg.journal_dir
        kwargs["journal_repair"] = cfg.journal_repair
    try:
        return make_backend(cfg.storage, **kwargs), tmpdir
    except BaseException:
        # construction can raise after the tempdir exists (e.g. a
        # ChecksumError from a corrupt journal): don't orphan it
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
        raise


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


class _Ops:
    """The chain's operators: per-step forward/backward for the interpreted
    engine and the Revolve/conventional strategies, plus the per-segment
    ops (``CompiledChainOps``) of the compiled engine."""

    def __init__(self, spec: ChainSpec, xs_treespec, xs_mask):
        self.spec = spec
        self.xs_mask = xs_mask
        self.cops = CompiledChainOps(spec.body, xs_treespec, xs_mask)

    def fwd(self, params, state, x, batch):
        with torch.no_grad():
            return self.spec.body(params, state, x, batch)

    def bwd(self, params, state, xs, k: int, batch, dcarry, gacc):
        """The vjp of step ``k`` from its input ``state``: ``(dc, gacc +
        dparams, dxd)``, ``dxd`` the cotangents of step ``k``'s inexact
        ``xs`` leaves.  ``gacc`` is added to in place where it holds
        memory (:func:`accumulate`)."""
        x_k = pytree.tree_map(lambda leaf: leaf[k:k + 1], xs)
        dp, dc, dxd = steps_vjp(self.spec.body, params, state, x_k, batch,
                                self.xs_mask, dcarry)
        return dc, accumulate(gacc, dp), [d[0] for d in dxd]

    @staticmethod
    def zero_grads(params):
        """Broadcast zeros, which hold no memory (:func:`accumulate`)."""
        return pytree.tree_map(lambda t: t.new_zeros(()).expand_as(t),
                               params)


def _resolve_schedule(static: _Static, ops: _Ops, params, carry0, xs, batch,
                      n: int, engine) -> at.TuneResult:
    cfg = static.cfg
    tuner = _TUNERS.get(cfg.tuner_id, at.GLOBAL_TUNER)
    if cfg.interval is not None:
        return tuner.manual(static.spec.name, n=n, interval=cfg.interval,
                            slots=cfg.slots)
    if cfg.strategy != "multistage_async" or not cfg.autotune \
            or engine is None:
        return tuner.manual(static.spec.name, n=n,
                            interval=max(1, min(n, 32)), slots=cfg.slots)
    # T_A depends on the engine (per-step dispatch vs a segment runner's
    # amortised step) and on the runner: both are part of the cache identity
    tune_name = f"{static.spec.name}:{cfg.engine}"
    if cfg.runner == "fused":
        tune_name += ":fused"
    if cfg.engine == "interpreted":
        def forward_step(state, k):
            return ops.fwd(params, state, index_xs(xs, k), batch)

        tune = tuner.measure(tune_name, forward_step=forward_step,
                             state0=carry0, n=n, engine=engine)
    else:
        # T_A is the amortised per-step time of a segment: probe one
        # advance over a short prefix whose length is a snap candidate of n
        cap = max(1, min(n, 32))
        cand = choose_interval(n, cap)
        probe_len = cand if cand >= min(cap, 8) else cap
        xs_probe = pytree.tree_map(
            lambda leaf: leaf[:probe_len].contiguous(), xs)
        store_tree = None
        if cfg.runner == "fused":
            # probe the fused path: T_A includes the in-kernel boundary
            # copy, and T_T stores what a fused advance hands the store —
            # the chunk entry the kernel already wrote to host memory
            last = None

            def forward_segment(state):
                nonlocal last
                last = segment_fused.fused_advance_segment(
                    ops.cops.body, params, state, xs_probe, batch,
                    chunk=probe_len)
                return last.carry

            def store_tree():
                return HostTree(last.entries[0], last.ready)
        else:
            def forward_segment(state):
                return ops.cops.advance_segment(params, state, xs_probe,
                                                batch)

        tune = tuner.measure(tune_name, forward_segment=forward_segment,
                             segment_len=probe_len, state0=carry0, n=n,
                             engine=engine, store_tree=store_tree)
    if cfg.slots is not None:
        tune = dataclasses.replace(tune, slots=cfg.slots)
    return tune


def _fingerprint_leaves(tree):
    """The leaves of ``tree`` in the JAX package's order (a dict's by
    sorted key, where torch's pytree keeps insertion order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _fingerprint_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _fingerprint_leaves(x)
    elif tree is not None:
        yield tree


def _input_fingerprint(*trees) -> str:
    """Sampled identity of the gradient call's inputs
    (params/carry0/xs/batch): per-leaf shape+dtype+nbytes plus a CRC of
    bounded prefix/middle/suffix slices.  Written into the journal's
    BEGIN record and checked before a resume — resuming a crashed sweep
    under *different* inputs (e.g. a restart from an older model
    checkpoint with a stale journal) would silently mix two parameter
    sets into one gradient, so a mismatch falls back to a fresh,
    journaled run.

    The check is probabilistic by design: hashing every byte of a
    multi-GB pytree per gradient call is not affordable, so O(KB) per
    leaf is sampled from three spread-out slices, cut on the device
    before they are copied to the host.  The digest is the JAX package's
    for the same values (a bf16 leaf hashes its raw bits under the name
    ``bfloat16``, as ``ml_dtypes`` names it there)."""
    crc = 0
    for tree in trees:
        for leaf in _fingerprint_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                t = leaf.detach()
                if t.dtype == torch.bfloat16:
                    name, t = "bfloat16", t.view(torch.int16)
                else:
                    name = str(torch.empty(0, dtype=t.dtype).numpy().dtype)
                shape, nbytes = tuple(t.shape), t.numel() * t.element_size()
                flat, item = t.reshape(-1), t.element_size()
            else:
                a = np.asarray(leaf)
                name, shape, nbytes = a.dtype, a.shape, a.nbytes
                if not a.flags.c_contiguous:
                    a = np.ascontiguousarray(a)
                flat, item = a.reshape(-1), a.itemsize
            crc = zlib.crc32(f"{shape}{name}{nbytes}".encode(), crc)
            n = flat.shape[0]
            k = max(1, 2048 // max(1, item))
            for sl in (flat[:k], flat[max(0, n // 2 - k // 2):
                                      n // 2 + k // 2 + 1], flat[-k:]):
                if isinstance(sl, torch.Tensor):
                    sl = sl.cpu().numpy()
                crc = zlib.crc32(np.ascontiguousarray(sl).tobytes(), crc)
    return f"{crc:08x}"


class _RunRecord:
    """What the backward pass needs from the forward: the strategy's
    in-flight run (multistage; closed if the backward pass never comes),
    the schedule, the operators and the chain inputs."""

    def __init__(self, strategy: str, ops: _Ops, inputs):
        self.strategy = strategy
        self.ops = ops
        self.inputs = inputs   # (params, carry0, xs, batch)
        self.tune: Optional[at.TuneResult] = None
        self.run = None
        self.tmpdir: Optional[str] = None   # Level-2 directory made here

    def dispose(self) -> None:
        if self.run is not None:
            run, self.run = self.run, None
            try:
                run.close()
            except Exception:
                pass
        if self.tmpdir is not None:
            shutil.rmtree(self.tmpdir, ignore_errors=True)
            self.tmpdir = None

    def __del__(self):
        self.dispose()


def _fwd(static: _Static, params, carry0, xs, batch):
    spec, cfg = static.spec, static.cfg
    n = chain_length(xs)
    ops = _Ops(spec, static.xs_treespec, static.xs_mask)
    rec = _RunRecord(cfg.strategy, ops, (params, carry0, xs, batch))
    if cfg.strategy == "multistage_async":
        device = pytree.tree_leaves(carry0)[0].device
        backend, rec.tmpdir = _make_backend(cfg)
        engine = None
        try:
            engine = AsyncTransferEngine(backend, device=device)
            if cfg.runner == "fused":
                segment_fused.check_token_range(spec.body, params, xs)
            recovered = None
            fingerprint = None
            if cfg.journal_dir is not None:
                fingerprint = _input_fingerprint(params, carry0, xs, batch)
            if cfg.resume:
                # what survived the crash: durable boundary keys + the last
                # plan cursor.  Unusable recoveries (no cursor, a cleanly
                # finished run, a different chain length, or inputs that
                # do not match the crashed run's fingerprint) fall back to
                # a fresh — still journaled — run.
                recovered = backend.recover()
                cur = recovered.cursor
                old_fp = recovered.meta.get("fingerprint")
                if cur is None or cur.phase == "done" or cur.n != n or \
                        (old_fp is not None and old_fp != fingerprint):
                    recovered = None
            if recovered is not None:
                # the journal cursor pins the schedule: resuming under a
                # different (I, s) than the crashed run would orphan its
                # durable boundaries
                tuner = _TUNERS.get(cfg.tuner_id, at.GLOBAL_TUNER)
                tune = tuner.manual(spec.name, n=n,
                                    interval=recovered.cursor.interval,
                                    slots=recovered.cursor.s_l1)
            else:
                tune = _resolve_schedule(static, ops, params, carry0, xs,
                                         batch, n, engine)
            runner = None   # the interpreted engine: per-step operators
            if cfg.engine == "compiled":
                runner_cls = FusedSegmentRunner if cfg.runner == "fused" \
                    else CompiledSegmentRunner
                runner = runner_cls(ops.cops, params, xs, batch,
                                    s_l1=tune.slots)

            def fwd_op(state, k):
                return ops.fwd(params, state, index_xs(xs, k), batch)

            x_n, run = CheckpointExecutor(fwd_op, None).multistage_forward(
                carry0, n, interval=tune.interval, s_l1=tune.slots,
                engine=engine, runner=runner, resume_from=recovered,
                run_meta={"fingerprint": fingerprint}
                if fingerprint is not None else None)
        except BaseException:
            # multistage_forward treats a passed-in engine as borrowed and
            # won't close it on error — engine and backend are ours, so
            # close both here (a journaled backend holds an open WAL fd;
            # leaking it across an in-process retry loop piles up fds)
            if engine is not None:
                try:
                    engine.close()
                except Exception:
                    pass
            bclose = getattr(backend, "close", None)
            if bclose is not None:
                try:
                    bclose()
                except Exception:
                    pass
            rec.dispose()
            raise
        run.own_engine = True
        rec.run = run
        _LAST["plan"] = run.plan
    else:
        # the baselines keep nothing from the forward: the backward pass
        # recomputes from carry_0 under the strategy's schedule
        tune = _resolve_schedule(static, ops, params, carry0, xs, batch, n,
                                 None)
        x_n = ops.cops.advance_segment(params, carry0, xs, batch)
        _LAST["plan"] = None
    rec.tune = tune
    _LAST["tune"] = tune
    return x_n, rec


def _bwd(static: _Static, rec: _RunRecord, dcarry):
    run = rec.run
    if rec.ops is None or (rec.strategy == "multistage_async"
                           and run is None):
        raise RuntimeError("offloaded-chain run is no longer live (backward "
                           "called twice?); re-run the forward pass")
    ops, (params, carry0, xs, batch) = rec.ops, rec.inputs
    rec.ops = None
    n = chain_length(xs)
    collect_dx = any(static.xs_mask)
    dx_slices: Dict[int, Any] = {}

    def fwd_op(state, k):
        return ops.fwd(params, state, index_xs(xs, k), batch)

    def bwd_op(state, adjoint, k):
        dc, gacc = adjoint
        dc, gacc, dxd = ops.bwd(params, state, xs, k, batch, dc, gacc)
        if collect_dx:
            dx_slices[k] = dxd
        return dc, gacc

    ex = CheckpointExecutor(fwd_op, bwd_op)
    adjoint0 = (dcarry, ops.zero_grads(params))
    runner = run.runner if run is not None else None

    # Journaled runs checkpoint each reversed segment's per-step input
    # cotangents alongside the adjoint cursor, so a mid-sweep resume can
    # still stitch the full-chain dxs without re-reversing anything.
    def artifact_fn(seg):
        if isinstance(runner, CompiledSegmentRunner):
            return runner.dx_of(seg)
        if collect_dx:
            return {k: dx_slices[k]
                    for k in range(seg.begin, seg.end) if k in dx_slices}
        return None

    def restore_artifact_fn(begin, artifact):
        if artifact is None:
            return
        artifact = placed(artifact, dcarry)   # host arrays from the journal
        if isinstance(runner, CompiledSegmentRunner):
            runner.keep_dx(begin, artifact)
        else:
            dx_slices.update(artifact)

    try:
        if rec.strategy == "multistage_async":
            adjoint, stats = ex.multistage_reverse(
                run, adjoint0, artifact_fn=artifact_fn,
                restore_artifact_fn=restore_artifact_fn)
        elif rec.strategy == "revolve":
            adjoint, stats = ex.run_revolve(carry0, n, adjoint0,
                                            s=rec.tune.slots)
        else:  # conventional
            adjoint, stats = ex.run_conventional(carry0, n, adjoint0)
    finally:
        rec.dispose()   # idempotent: the reverse already closed the run
    _LAST["stats"] = stats
    dcarry0, gparams = adjoint
    if not collect_dx:
        dxs_diff = []
    elif runner is not None:
        # the full-chain arrays each reversed segment wrote its part of
        dxs_diff = runner.collect_dx()
    else:
        dxs_diff = [torch.stack([dx_slices[k][i] for k in range(n)])
                    for i in range(sum(static.xs_mask))]
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
        ctx.static, ctx.rec, ctx.c_spec = static, rec, c_spec
        return tuple(pytree.tree_leaves(x_n))

    @staticmethod
    def backward(ctx, *dcarry_leaves):
        dcarry = pytree.tree_unflatten(list(dcarry_leaves), ctx.c_spec)
        gparams, dcarry0, dxs_diff = _bwd(ctx.static, ctx.rec, dcarry)
        # a parameter the steps never read gets no gradient here (its
        # accumulator is still a broadcast zero), not a buffer of zeros
        # that autograd would add to its other gradient
        gparams = [None if is_broadcast_zero(g) else g
                   for g in pytree.tree_leaves(gparams)]
        return (None, None, *gparams, *pytree.tree_leaves(dcarry0),
                *dxs_diff)


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
    storage_dir: Optional[str] = None,
    l2_capacity_bytes: Optional[int] = None,
    backend: Optional[Any] = None,
    journal_dir: Optional[str] = None,
    resume: bool = False,
    journal_repair: bool = False,
    autotune: bool = True,
    tuner: Optional[at.AutoTuner] = None,
    fallback: bool = True,
    engine: str = "compiled",
    runner: str = "compiled",
    device=None,
    mesh: Optional[Any] = None,
    step_memory_budget: Optional[int] = None,
    plan_2d: Optional[Tuple[int, int]] = None,
    offload_params: Optional[str] = None,
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
    ``I = ceil(T_T/T_A)``.  ``storage`` picks the Level-2 backend from the
    registry (``"ram"``, ``"disk"``, ``"compressed"`` — int8-quantised
    float states, ~4x smaller at a bounded precision cost — ``"tiered"``,
    or a kind added with ``register_backend``); ``storage_dir`` is the
    directory of a disk store (a temporary one, removed with the run, when
    None).  ``l2_capacity_bytes`` (required with ``"tiered"``) is the
    fast-tier budget: cold boundaries spill to disk in plan-aware (Belady)
    order and are promoted back ahead of need, and the autotuner probes
    both tiers.  ``backend=`` hands the transform a live Level-2 store
    instead (e.g. a ``NamespacedStorage`` view of one shared
    ``TieredStorage``), never closed by the run; it excludes the storage
    knobs.  ``journal_dir`` write-ahead-logs the run's Level-2 stores,
    deletes and segment cursors there (CRC'd records, one fsync a segment),
    so a crashed run can be finished with :func:`resume_offloaded` (or
    ``resume=True``); ``journal_repair=True`` truncates a CRC-damaged
    journal back to its last good record instead of raising
    ``ChecksumError``.  ``strategy="revolve"`` (with ``slots`` Level-1
    slots) and ``strategy="conventional"`` run the paper's baselines over
    per-step operators; ``engine="interpreted"`` runs the multistage plan one
    step per dispatch.  ``runner="fused"`` (the JAX package's
    ``runner="pallas"``) runs the hand-written CUDA segment kernels on the
    card — the LSTM chain step only; other chains raise ``ValueError`` there
    — and their plain PyTorch versions on the CPU.  ``mesh``,
    ``step_memory_budget``, ``plan_2d`` and ``offload_params`` are the JAX
    package's knobs that are not ported yet: each raises
    ``NotImplementedError`` naming its ROADMAP item.

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
    if backend is not None:
        if storage != "ram" or storage_dir is not None or \
                l2_capacity_bytes is not None:
            raise ValueError(
                "pass either backend= (an already-built Level-2 store) or "
                "the storage=/storage_dir=/l2_capacity_bytes= kind knobs, "
                "not both")
        storage = "shared"
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
                        storage=storage, storage_dir=storage_dir,
                        l2_capacity_bytes=l2_capacity_bytes,
                        journal_dir=journal_dir, resume=resume,
                        journal_repair=journal_repair,
                        autotune=autotune, tuner_id=_register_tuner(tuner),
                        backend_id=_register_shared_backend(backend),
                        engine=engine, runner=runner, mesh=mesh,
                        step_memory_budget=step_memory_budget,
                        plan_2d=tuple(plan_2d) if plan_2d is not None
                        else None,
                        offload_params=offload_params)
    vg = _value_and_grad(offloaded_loss(spec, cfg), dev)
    vg.chain_spec = spec
    vg.offload_config = cfg
    # keep the weak registry entries alive for as long as the transform is
    vg.tuner = tuner
    vg.backend = backend
    vg.device = dev
    return vg


def resume_offloaded(
    loss_fn,
    params,
    batch,
    *,
    journal_dir: str,
    repair: bool = False,
    **opts,
) -> Tuple[Any, Any]:
    """Resume a crashed offloaded gradient from its write-ahead journal.

    Recovers the journal in ``journal_dir`` (written by a
    ``value_and_grad_offloaded(..., journal_dir=...)`` transform that was
    killed mid-run) and finishes the gradient step-exactly: a
    forward-phase crash replays from the last durable boundary (at most
    one interval of steps — ``last_stats().replayed_advances``), a
    reverse-phase crash restarts mid-sweep from the journaled adjoint
    cursor without re-reversing any completed segment.  ``params`` and
    ``batch`` must be the ones the crashed run used — determinism is what
    makes the resumed gradient bit-identical to the fault-free one (on the
    card, with ``torch.use_deterministic_algorithms(True)`` set by the
    caller wherever a library call could pick a nondeterministic kernel).

    Returns ``(loss, grads)`` exactly like the transform would have.  If
    the journal holds nothing resumable (no cursor, or a run that already
    completed), the gradient is simply recomputed from scratch — still
    journaled, so the call is safe to use as the generic retry path.

    ``repair=True`` truncates a CRC-damaged journal back to its last good
    record instead of raising
    :class:`~repro_torch.core.faults.ChecksumError` (resume then replays
    from whatever precedes the damage).  Remaining keyword options are
    those of :func:`value_and_grad_offloaded` — pass the same
    ``storage``/``engine``/``runner`` configuration the crashed run used.
    """
    vg = value_and_grad_offloaded(loss_fn, journal_dir=journal_dir,
                                  resume=True, journal_repair=repair,
                                  **opts)
    return vg(params, batch)


def checkpointed_bptt(body: Callable[[Any, Any, Any], Tuple[Any, Any]],
                      **opts) -> Callable[[Any, Any, Any], Tuple[Any, Any]]:
    """BPTT through a scan-style chain with offloaded checkpointing.

    ``body(params, carry, x) -> (carry, loss_k)`` is one chain step (an RNN
    time step, a transformer layer, ...).  Returns ``bptt(params, carry0,
    xs) -> (total_loss, grads)``, ``total_loss`` the sum of the per-step
    losses and ``grads`` shaped like ``params``.  Keyword options are those
    of :func:`value_and_grad_offloaded`.

    >>> import torch
    >>> from repro_torch import api
    >>> def body(p, c, x):
    ...     c = torch.tanh(c + p * x)
    ...     return c, c ** 2
    >>> bptt = api.checkpointed_bptt(body, interval=4, slots=2, device="cpu")
    >>> xs = torch.linspace(0.0, 1.0, 8)
    >>> loss, grad = bptt(torch.tensor(0.3), torch.tensor(0.0), xs)
    >>> p = torch.tensor(0.3, requires_grad=True)
    >>> c, ref = torch.tensor(0.0), 0.0
    >>> for x in xs:
    ...     c, l_k = body(p, c, x)
    ...     ref = ref + l_k
    >>> (ref_grad,) = torch.autograd.grad(ref, p)
    >>> bool(torch.allclose(loss, ref)), bool(torch.allclose(grad, ref_grad))
    (True, True)
    """

    def prelude(params, batch):
        carry0, xs = batch
        return (carry0, torch.zeros((), dtype=torch.float32,
                                    device=pytree.tree_leaves(xs)[0].device)
                ), xs

    def chain_body(params, c, x, batch):
        carry, acc = c
        carry, loss_k = body(params, carry, x)
        return carry, acc + loss_k.sum().to(torch.float32)

    def readout(params, c, batch):
        return c[1]

    spec = ChainSpec(prelude, chain_body, readout,
                     name=getattr(body, "__name__", "bptt"))
    vg = value_and_grad_offloaded(spec, **opts)

    def bptt(params, carry0, xs):
        return vg(params, (carry0, xs))

    bptt.chain_spec = spec
    return bptt
