"""Chaos suite of the port (a port of ``tests/test_fault_injection.py``):
injected Level-2 storage faults against the journaled multistage executor
and the ``repro_torch.api`` front door, on the CPU.

For any chain (n, I, s), Level-2 backend and injected fault, a journaled
run either completes with gradients **bit-identical** (``torch.equal``) to
the fault-free run over the same backend, or raises a typed
:class:`~repro_torch.core.faults.StorageFault`; after any injected crash,
resuming from the journal reproduces the fault-free gradient exactly,
re-executing at most one interval of forward steps.  The fault-free
gradients agree with the JAX package's within 1e-5 (executor level) and
1e-4 (front door), and the front door's typed faults, resumes and
``OffloadConfig`` errors are those of the JAX package.

Fault classes: writer-thread death mid-store, demand-fetch failure, torn
journal record (crash mid-write), checksum flip (bit rot); plus the
engine-level units of the fault hooks and of the cursor's snapshot at
enqueue (the reverse sweep adds into its accumulator in place).
"""
import itertools
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st  # optional dep, see shim

from repro import api as j_api
from repro.core import faults as j_faults
from repro.core.executor import CheckpointExecutor as JExecutor
from repro_torch import api
from repro_torch.core import faults
from repro_torch.core.executor import CheckpointExecutor
from repro_torch.core.faults import (ChecksumError, FaultPlan,
                                     InjectedFault, StorageFault)
from repro_torch.core.schedule import RunCursor
from repro_torch.core.storage import (AsyncTransferEngine, JournaledStorage,
                                      RAMStorage, make_backend)

N, INTERVAL, SLOTS = 14, 4, 3
_UNIQ = itertools.count()


def _tree_equal(a, b) -> bool:
    la = torch.utils._pytree.tree_leaves(a)
    lb = torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# executor-level harness
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_W = (_RNG.standard_normal((8, 8)) * 0.5).astype(np.float32)
_X0 = _RNG.standard_normal((4, 8)).astype(np.float32)


def chain(n):
    """The reference suite's chain, x_{k+1} = tanh(x_k W + 0.01 k), with a
    loss sum(x_n^2) seeded at the last step, in torch."""
    W = torch.as_tensor(_W)

    def step(x, k):
        return torch.tanh(x @ W + k * 0.01)

    def fwd(x, k):
        with torch.no_grad():
            return step(x, k)

    def bwd(x_k, adj, k):
        x = x_k.detach().requires_grad_(True)
        with torch.enable_grad():
            y = step(x, k)
            if k == n - 1:
                (g,) = torch.autograd.grad((y ** 2).sum(), x)
            else:
                (g,) = torch.autograd.grad(y, x, adj)
        return g

    return fwd, bwd, torch.as_tensor(_X0)


_J_REF = {}


def _jax_gradient(n, interval, slots):
    """The JAX package's gradient of the same chain (executor, no
    journal)."""
    key = (n, interval, slots)
    if key not in _J_REF:
        W = jnp.asarray(_W)

        def step(x, k):
            return jnp.tanh(x @ W + k * 0.01)

        def bwd(x_k, adj, k):
            if k == n - 1:
                return jax.grad(lambda x: jnp.sum(step(x, k) ** 2))(x_k)
            _, vjp = jax.vjp(lambda x: step(x, k), x_k)
            return vjp(adj)[0]

        x0 = jnp.asarray(_X0)
        g, _ = JExecutor(step, bwd).run_multistage(
            x0, n, jnp.zeros_like(x0), interval=interval, s_l1=slots)
        _J_REF[key] = np.asarray(g)
    return _J_REF[key]


def _backend_kwargs(kind: str, base: str):
    sub = os.path.join(base, f"l2_{next(_UNIQ)}")
    if kind == "disk":
        return {"directory": sub}
    if kind == "tiered":
        return {"directory": sub, "capacity_bytes": 300}  # forces spills
    if kind == "compressed":
        # the chain state is 128 B: drop the threshold so int8 quantisation
        # engages and the bit-identical contract meets a lossy codec
        return {"min_bytes": 64}
    return {}


def _exec_run(base, jd, *, n=N, interval=INTERVAL, slots=SLOTS, kind="ram",
              fault_plan=None, resume=False, repair=False):
    """One executor-level journaled gradient; returns (grad, stats)."""
    fwd, bwd, x0 = chain(n)
    ctx = faults.inject(fault_plan) if fault_plan is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        backend = make_backend(kind, journal=jd, journal_repair=repair,
                               **_backend_kwargs(kind, base))
        rec = backend.recover() if resume else None
        ex = CheckpointExecutor(fwd, bwd)
        eng = AsyncTransferEngine(backend, device="cpu")
        try:
            x_n, run = ex.multistage_forward(
                x0, n, interval=interval, s_l1=slots, engine=eng,
                resume_from=rec)
            g, st = ex.multistage_reverse(run, torch.zeros_like(x0))
        finally:
            try:
                eng.close()
            except Exception:
                pass
            backend.close()
        return g, st
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


def _chaos_check(*, n, interval, slots, kind, fault_plan, jax_ref=False):
    """The chaos property for one (chain, backend, fault) combination."""
    with tempfile.TemporaryDirectory() as base:
        jd_ok = os.path.join(base, "wal_ok")
        g_ref, _ = _exec_run(base, jd_ok, n=n, interval=interval,
                             slots=slots, kind=kind)
        if jax_ref and kind != "compressed":
            np.testing.assert_allclose(
                g_ref.numpy(), _jax_gradient(n, interval, slots),
                rtol=1e-5, atol=1e-5)
        jd = os.path.join(base, "wal")
        try:
            g, _ = _exec_run(base, jd, n=n, interval=interval, slots=slots,
                             kind=kind, fault_plan=fault_plan)
            assert torch.equal(g, g_ref), \
                "faulted run completed with different gradients"
            return "completed"
        except StorageFault:
            pass  # typed — now resume must reproduce the gradient exactly
        try:
            g, st = _exec_run(base, jd, n=n, interval=interval, slots=slots,
                              kind=kind, resume=True)
        except ChecksumError:
            g, st = _exec_run(base, jd, n=n, interval=interval, slots=slots,
                              kind=kind, resume=True, repair=True)
        assert torch.equal(g, g_ref), "resume diverged from fault-free run"
        assert st.replayed_advances <= interval, \
            f"resume replayed {st.replayed_advances} > one interval"
        return "resumed"


# ---------------------------------------------------------------------------
# example-based chaos: one deterministic case per fault class
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_writer_death_resumes_exact(k):
    outcome = _chaos_check(n=N, interval=INTERVAL, slots=SLOTS, kind="ram",
                           fault_plan=FaultPlan(kill_writer_at_store=k),
                           jax_ref=True)
    assert outcome == "resumed"


@pytest.mark.parametrize("j", [0, 1, 3])
def test_demand_fetch_failure_resumes_exact(j):
    outcome = _chaos_check(n=N, interval=INTERVAL, slots=SLOTS, kind="ram",
                           fault_plan=FaultPlan(fail_get_at=j), jax_ref=True)
    assert outcome == "resumed"


def test_torn_journal_record_resumes_exact():
    """Crash tearing a STORE record mid-write: the torn tail is discarded
    on reopen (no error) and the resume replays from the last intact
    boundary."""
    outcome = _chaos_check(
        n=N, interval=INTERVAL, slots=SLOTS, kind="ram",
        fault_plan=FaultPlan(truncate_journal_at_store=2))
    assert outcome == "resumed"


def test_checksum_flip_in_completed_run_is_compacted_away():
    """A flipped payload byte is silent while the in-process copy serves
    reads: the run completes bit-identically, and the end-of-run
    compaction rewrites the WAL as a clean done-marker epoch."""
    with tempfile.TemporaryDirectory() as base:
        g_ref, _ = _exec_run(base, os.path.join(base, "wal_ok"))
        jd = os.path.join(base, "wal")
        g, _ = _exec_run(base, jd, fault_plan=FaultPlan(flip_byte_at_store=1))
        assert torch.equal(g, g_ref)
        reopened = make_backend("ram", journal=jd)
        rec = reopened.recover()
        reopened.close()
        assert rec.cursor is not None and rec.cursor.phase == "done"
        assert rec.keys == ()


def test_checksum_flip_detected_and_repaired():
    """flip + crash: reopen raises ChecksumError; repair truncates to the
    last good record and resume reproduces the fault-free gradient."""
    outcome = _chaos_check(
        n=N, interval=INTERVAL, slots=SLOTS, kind="ram",
        fault_plan=FaultPlan(flip_byte_at_store=1, kill_writer_at_store=3))
    assert outcome == "resumed"


@pytest.mark.parametrize("kind", ["disk", "compressed", "tiered"])
def test_writer_death_all_backends(kind):
    """Raw payloads in the WAL, resume replay from exact records
    (get_exact), and re-hydrated reverse reads round-tripped through the
    (possibly lossy) codec, over every inner store."""
    outcome = _chaos_check(n=N, interval=INTERVAL, slots=SLOTS, kind=kind,
                           fault_plan=FaultPlan(kill_writer_at_store=2))
    assert outcome == "resumed"


# ---------------------------------------------------------------------------
# engine-level units: the fault hooks and the cursor snapshot
# ---------------------------------------------------------------------------


def test_killed_writer_leaves_its_item_undone():
    """WriterKilled ends the writer thread without task_done, so the join
    reports WriterCrashError, as the JAX package's engine does."""
    from repro_torch.core.faults import WriterCrashError

    with faults.inject(FaultPlan(kill_writer_at_store=1)) as inj:
        eng = AsyncTransferEngine(RAMStorage())
    eng.store_async(0, torch.ones(3))
    eng.store_async(1, torch.ones(3))
    with pytest.raises(WriterCrashError):
        eng.wait_stores()
    assert inj.fired == [("kill_writer", 1)]
    assert 0 in eng.backend and 1 not in eng.backend
    with pytest.raises(Exception):
        eng.close()


def test_fetch_hook_fires_on_prefetch_and_demand_fetch():
    with faults.inject(FaultPlan(fail_get_at=1)) as inj:
        eng = AsyncTransferEngine(RAMStorage(), device="cpu")
    eng.store_async(0, torch.ones(3))
    eng.store_async(1, torch.zeros(3))
    eng.wait_stores()
    assert torch.equal(eng.wait_prefetch(0), torch.ones(3))   # get 0
    eng.prefetch_async(1)                                     # get 1 fails
    with pytest.raises(InjectedFault):
        eng.wait_prefetch(1)
    assert inj.gets == 2 and inj.fired == [("fail_get", 1)]
    eng.close()


def test_engine_reads_the_injector_once_at_construction():
    eng = AsyncTransferEngine(RAMStorage())
    assert eng.faults is None
    with faults.inject(FaultPlan(kill_writer_at_store=0)):
        eng.store_async(0, torch.ones(2))   # built outside: unaffected
    eng.wait_stores()
    eng.close()


@pytest.mark.parametrize("device", [None, "cpu"])
def test_cursor_payload_is_snapshotted_at_enqueue(tmp_path, device):
    """The writer is held back (a slow store ahead of the cursor) while the
    caller adds into the adjoint in place, as the next reverse segment
    does: the journaled cursor still holds the adjoint and artifact as
    they were at ``cursor_async``, in this process and in a fresh one."""
    gate = threading.Event()

    class Slow(RAMStorage):
        def put(self, key, tree):
            gate.wait(10.0)
            super().put(key, tree)

    jd = str(tmp_path / "wal")
    js = JournaledStorage(Slow(), jd)
    eng = AsyncTransferEngine(js, device=device)
    acc = torch.zeros(4)
    dx = [torch.arange(3, dtype=torch.float32)]
    eng.store_async(0, torch.ones(2))          # the writer blocks here
    eng.cursor_async(RunCursor(
        plan_id="p", n=4, interval=2, s_l1=2, phase="reverse",
        segment_index=0, payload={"adjoint": (acc, {"w": acc}),
                                  "artifact": dx, "artifact_key": 2}))
    acc.add_(1.0)
    dx[0].mul_(-1.0)
    gate.set()
    eng.wait_stores()
    eng.close()
    for rec in (js.recover(), None):
        if rec is None:
            js.close()
            fresh = make_backend("ram", journal=jd)
            rec = fresh.recover()
            fresh.close()
        dc, g = rec.cursor.payload["adjoint"]
        assert isinstance(dc, np.ndarray)
        np.testing.assert_array_equal(dc, np.zeros(4, np.float32))
        np.testing.assert_array_equal(g["w"], np.zeros(4, np.float32))
        np.testing.assert_array_equal(rec.artifacts[2][0],
                                      np.arange(3, dtype=np.float32))


# ---------------------------------------------------------------------------
# front door chaos (through the autograd Function), against the JAX package
# ---------------------------------------------------------------------------

_A_RNG = np.random.default_rng(0)
_AW = (_A_RNG.standard_normal((4, 4)) * 0.3).astype(np.float32)
_AXS = (_A_RNG.standard_normal((12, 2, 4)) * 0.1).astype(np.float32)


def _body(p, c, x):
    c = torch.tanh(c @ p["W"] + x)
    return c, (c ** 2).sum()


def _j_body(p, c, x):
    c = jnp.tanh(c @ p["W"] + x)
    return c, jnp.sum(c ** 2)


def _make_bptt(engine, jd=None, resume=False, repair=False):
    return api.checkpointed_bptt(_body, interval=INTERVAL, slots=2,
                                 engine=engine, journal_dir=jd,
                                 resume=resume, journal_repair=repair,
                                 device="cpu")


def _api_inputs():
    return ({"W": torch.as_tensor(_AW)}, torch.zeros(2, 4),
            torch.as_tensor(_AXS))


def _jax_api(engine):
    bptt = j_api.checkpointed_bptt(_j_body, interval=INTERVAL, slots=2,
                                   engine=engine)
    v, g = bptt({"W": jnp.asarray(_AW)}, jnp.zeros((2, 4)),
                jnp.asarray(_AXS))
    return float(v), np.asarray(g["W"])


@pytest.mark.parametrize("engine", ["compiled", "interpreted"])
@pytest.mark.parametrize("plan", [
    FaultPlan(kill_writer_at_store=1),
    FaultPlan(fail_get_at=1),
], ids=["writer-death", "fetch-failure"])
def test_api_crash_is_typed_and_resume_is_exact(engine, plan):
    params, c0, xs = _api_inputs()
    v_ref, g_ref = _make_bptt(engine)(params, c0, xs)
    j_v, j_g = _jax_api(engine)
    np.testing.assert_allclose(float(v_ref), j_v, rtol=1e-5)
    np.testing.assert_allclose(g_ref["W"].numpy(), j_g, rtol=1e-4,
                               atol=1e-4 * np.abs(j_g).max())
    with tempfile.TemporaryDirectory() as base:
        jd = os.path.join(base, "wal")
        with pytest.raises(Exception) as ei:
            with faults.inject(plan):
                _make_bptt(engine, jd)(params, c0, xs)
        assert faults.is_storage_fault(ei.value), \
            f"crash was not a typed StorageFault: {ei.value!r}"
        # the JAX package's front door raises the same typed fault
        with pytest.raises(Exception) as j_ei:
            with j_faults.inject(j_faults.FaultPlan(
                    kill_writer_at_store=plan.kill_writer_at_store,
                    fail_get_at=plan.fail_get_at)):
                j_api.checkpointed_bptt(
                    _j_body, interval=INTERVAL, slots=2, engine=engine,
                    journal_dir=os.path.join(base, "j_wal"))(
                    {"W": jnp.asarray(_AW)}, jnp.zeros((2, 4)),
                    jnp.asarray(_AXS))
        assert type(ei.value).__name__ in str(j_ei.value) or \
            type(ei.value).__name__ == type(j_ei.value).__name__
        spec = _make_bptt(engine).chain_spec
        v, g = api.resume_offloaded(spec, params, (c0, xs), journal_dir=jd,
                                    interval=INTERVAL, slots=2,
                                    engine=engine, device="cpu")
        assert float(v) == float(v_ref)
        assert _tree_equal(g, g_ref), "api resume diverged"
        assert api.last_stats().replayed_advances <= INTERVAL


def test_api_journal_is_semantically_invisible():
    """journal_dir= does not change a healthy run's results by one bit,
    and resume of a *completed* run just recomputes (still exact)."""
    params, c0, xs = _api_inputs()
    v0, g0 = _make_bptt("compiled")(params, c0, xs)
    with tempfile.TemporaryDirectory() as base:
        jd = os.path.join(base, "wal")
        v1, g1 = _make_bptt("compiled", jd)(params, c0, xs)
        assert float(v0) == float(v1) and _tree_equal(g0, g1)
        spec = _make_bptt("compiled").chain_spec
        v2, g2 = api.resume_offloaded(spec, params, (c0, xs),
                                      journal_dir=jd, interval=INTERVAL,
                                      slots=2, device="cpu")
        assert float(v2) == float(v0) and _tree_equal(g2, g0)


def test_offload_config_validation():
    with pytest.raises(ValueError, match="resume=True needs journal_dir"):
        api.OffloadConfig(resume=True)
    with pytest.raises(ValueError, match="cannot be journaled"):
        api.OffloadConfig(engine="scan", journal_dir="/tmp/x")
    with pytest.raises(ValueError, match="keeps no Level-2 state"):
        api.OffloadConfig(strategy="revolve", journal_dir="/tmp/x")


@pytest.mark.parametrize("kw", [
    {"resume": True},
    {"strategy": "revolve", "journal_dir": "wal"},
    {"strategy": "conventional", "journal_dir": "wal", "resume": True},
    # several faults: the first in the JAX package's order is named
    {"resume": True, "strategy": "revolve"},
    {"storage": "tiered", "resume": True},
    {"backend_id": 1, "mesh": "MESH", "resume": True},
    {"engine": "scan", "journal_dir": "wal"},
    {"engine": "scan", "storage": "disk", "journal_dir": "wal"},
])
def test_journal_knobs_raise_the_same_value_errors_in_order(kw):
    from repro.api.frontend import OffloadConfig as JConfig

    with pytest.raises(ValueError) as j_err:
        JConfig(**kw)
    with pytest.raises(ValueError) as t_err:
        api.OffloadConfig(**kw)
    if kw.get("engine") == "scan":
        # the scan engine's own wording differs (XLA there): the same
        # check fails first
        what = "storage backends" if "storage" in kw else \
            "cannot be journaled"
        assert what in str(j_err.value) and what in str(t_err.value)
    else:
        assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# the chaos property, hypothesis-swept (marked slow, as the reference's)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@settings(max_examples=20, deadline=None)
@given(
    n=st.integers(min_value=2, max_value=20),
    interval=st.integers(min_value=1, max_value=7),
    slots=st.integers(min_value=2, max_value=5),
    kind=st.sampled_from(["ram", "disk", "compressed", "tiered"]),
    fault=st.sampled_from(["kill", "get", "tear", "flip"]),
    at=st.integers(min_value=0, max_value=6),
)
def test_chaos_property(n, interval, slots, kind, fault, at):
    """For random (n, I, s, backend, FaultPlan): bit-identical completion
    or typed StorageFault, and resume always reproduces the fault-free
    gradient with replayed_advances <= I."""
    plan = {
        "kill": FaultPlan(kill_writer_at_store=at),
        "get": FaultPlan(fail_get_at=at),
        "tear": FaultPlan(truncate_journal_at_store=at),
        # a bare flip is silent in-process; pair it with a crash so the
        # damaged journal is actually what recovery reads
        "flip": FaultPlan(flip_byte_at_store=at,
                          kill_writer_at_store=at + 1),
    }[fault]
    _chaos_check(n=n, interval=interval, slots=slots, kind=kind,
                 fault_plan=plan)
