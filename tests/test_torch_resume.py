"""Step-exact resume through the port's front door (a port of
``tests/test_resume.py``), held against the JAX package on the CPU.

A journaled run is killed at every segment boundary — writer death at each
forward store and a failed fetch at each reverse fetch — then resumed with
``resume_offloaded``, in both packages with the same crash.  Then:

* the port's resumed loss and gradients are bit-identical (``torch.equal``)
  to its fault-free run, and within 1e-4 of the JAX package's;
* the journal both packages recovered holds the same keys and cursor, and
  ``replayed_advances`` (<= I) and the other ``last_stats()`` counters of
  the resume equal the JAX package's, and the plan model's;

over the compiled and interpreted engines (``ram``; ``disk`` marked slow,
as in the reference), and for ``runner="fused"`` on ``lstm-paper`` SMOKE
(the fused kernels' plain versions here) against the JAX package's compiled
runner.  Also: the input fingerprint is the JAX package's, a stale journal
under different inputs falls back to a fresh run, a fault-free journaled
run is bit-identical to an unjournaled one, and a reverse crash resumes
exactly even when the journal writer lags the sweep (the cursor's adjoint
is snapshotted when it is enqueued: the sweep adds into it in place).
"""
import contextlib
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import api as j_api
from repro.api import frontend as j_fe
from repro.configs import base as j_base
from repro.configs.registry import get_config as j_get_config
from repro.configs.shapes import make_batch as j_make_batch
from repro.core import faults as j_faults
from repro.core import storage as j_storage
from repro.models.model_factory import get_model as j_get_model
from repro_torch import api
from repro_torch.api import frontend as fe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults
from repro_torch.core import revolve as rv
from repro_torch.core.compiled_ops import CompiledSegmentRunner
from repro_torch.core.executor import InterpretedSegmentRunner
from repro_torch.core.faults import FaultPlan
from repro_torch.core.storage import JournaledStorage, make_backend
from repro_torch.models.model_factory import get_model

T, B, D = 12, 2, 4
INTERVAL, SLOTS = 4, 2
M = T // INTERVAL          # segments in the plan

# engine x Level-2 storage (the disk variants prove journal-only
# re-hydration after the run's temporary Level-2 directory is gone; slow
# tier, as in the reference)
PATHS = [
    pytest.param("compiled", "ram", id="compiled-ram"),
    pytest.param("interpreted", "ram", id="interpreted-ram"),
    pytest.param("compiled", "disk", id="compiled-disk",
                 marks=pytest.mark.slow),
    pytest.param("interpreted", "disk", id="interpreted-disk",
                 marks=pytest.mark.slow),
]
COUNTERS = ("advances", "backwards", "replayed_advances", "host_dispatches",
            "l2_stores", "l2_prefetches")

_RNG = np.random.default_rng(0)
_W = (_RNG.standard_normal((D, D)) * 0.3).astype(np.float32)
_XS = (_RNG.standard_normal((T, B, D)) * 0.1).astype(np.float32)


def _body(p, c, x):
    c = torch.tanh(c @ p["W"] + x)
    return c, (c ** 2).sum()


def _j_body(p, c, x):
    c = jnp.tanh(c @ p["W"] + x)
    return c, jnp.sum(c ** 2)


def _tree_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _inputs():
    return {"W": torch.as_tensor(_W)}, torch.zeros(B, D), torch.as_tensor(_XS)


def _j_inputs():
    return {"W": jnp.asarray(_W)}, jnp.zeros((B, D)), jnp.asarray(_XS)


_BASE = {}


def _baseline(engine):
    """Fault-free (bptt, loss, grads) of the port and of the JAX package."""
    if engine not in _BASE:
        bptt = api.checkpointed_bptt(_body, interval=INTERVAL, slots=SLOTS,
                                     engine=engine, device="cpu")
        v, g = bptt(*_inputs())
        j_v, j_g = j_api.checkpointed_bptt(
            _j_body, interval=INTERVAL, slots=SLOTS, engine=engine)(
            *_j_inputs())
        _BASE[engine] = (bptt, (v, g), (float(j_v), np.asarray(j_g["W"])))
    return _BASE[engine]


def _reverse_advances(plan, engine, upto_j) -> int:
    """Plan-model advances for reversing segments 0..upto_j inclusive."""
    total = 0
    for seg in plan.segments[:upto_j + 1]:
        if engine == "interpreted":
            total += (seg.length - 1) if seg.revolve is None \
                else rv.count_advances(list(seg.revolve))
        else:  # compiled: vjp replay + one chunk rematerialisation pass
            total += seg.length * (2 if plan.inner_chunk(seg) is not None
                                   else 1)
    return total


def _recovered(make, jd):
    insp = make("ram", journal=jd)
    rec = insp.recover()
    insp.close()
    cur = rec.cursor
    return (tuple(rec.keys), None if cur is None
            else (cur.phase, cur.segment_index))


def _record_gets(inj):
    """The keys the port's injector ``inj`` sees fetched, in the order the
    fetches are issued (its get hook runs on the caller's thread, where a
    prefetch is issued)."""
    seen = []
    count = inj.on_get

    def on_get(key):
        seen.append(key)
        count(key)

    inj.on_get = on_get
    return seen


@contextlib.contextmanager
def _j_inject(plan, port_gets):
    """``plan`` in the JAX package, its fetch failure at the key of the
    port's ``fail_get_at``-th fetch (``port_gets``, from
    :func:`_record_gets`) and raised where the port raises it.

    The JAX package runs each prefetch on a thread of its own, whose fault
    hook counts the fetch and whose error the caller raises at its next
    wait.  Both depend on the threads' timing, and the journal a crash
    leaves follows them:

    * two prefetches are in flight at the start of the reverse sweep, and
      the later one can reach the count first, so ``fail_get_at`` may name
      another key;
    * a failed prefetch of segment ``j - 1``'s boundary, issued just before
      the wait for segment ``j``'s, is raised at that wait when its thread
      has run by then, and else at the next one, after segment ``j`` has
      been reversed and its cursor journaled.

    The plan fixes the order fetches are issued in, the same in both
    packages, and the port counts and raises in it (its hook runs where a
    prefetch is issued, and a failure is raised at the next wait).  So the
    JAX run fails the fetch of the same key, and the caller waits for that
    one prefetch's thread before it goes on: its error is then raised at the
    next wait, as the port's is.

    Yields the keys the JAX run fetched on the caller's thread, in the order
    it issued them (a prefetch where it is issued, a fetch with no prefetch
    where it is made), for :func:`_assert_same_fetches`."""
    key = None if plan.fail_get_at is None \
        else port_gets[plan.fail_get_at]
    engine = j_storage.AsyncTransferEngine
    issue = engine.prefetch_async
    lock, fired, issued = threading.Lock(), [], []
    caller = threading.get_ident()

    def on_get(k):
        if threading.get_ident() == caller:
            issued.append(k)
        with lock:
            hit = k == key and not fired
            if hit:
                fired.append(k)
        if hit:
            raise j_faults.InjectedFault(
                f"injected Level-2 fetch failure at key {k!r}")

    def prefetch_async(self, k):
        with self._lock:
            new = k not in self._prefetched \
                and k not in self._prefetch_events
        if new:
            issued.append(k)
        issue(self, k)
        if k == key:
            with self._lock:
                ev = self._prefetch_events.get(k)
            if ev is not None:
                ev.wait()

    with j_faults.inject(j_faults.FaultPlan(
            kill_writer_at_store=plan.kill_writer_at_store)) as j_inj:
        if key is not None:
            j_inj.on_get = on_get
            engine.prefetch_async = prefetch_async
        try:
            yield issued
        finally:
            engine.prefetch_async = issue


def _assert_same_fetches(plan, port_gets, j_issued):
    """The JAX run issued the same fetches as the port, in the same order,
    up to the one ``plan`` fails: the failing key was taken from the port's
    order, so this holds that order against the reference."""
    if plan.fail_get_at is not None:
        upto = plan.fail_get_at + 1
        assert j_issued[:upto] == port_gets[:upto]


def _crash_then_resume(engine, storage, plan):
    """Inject ``plan`` into both packages' journaled runs, expect a crash,
    resume each, and check the port against its fault-free run and the JAX
    package; returns (recovered, stats)."""
    bptt, (v_ref, g_ref), (j_v, j_g) = _baseline(engine)
    np.testing.assert_allclose(float(v_ref), j_v, rtol=1e-5)
    np.testing.assert_allclose(g_ref["W"].numpy(), j_g, rtol=1e-4,
                               atol=1e-4 * np.abs(j_g).max())
    with tempfile.TemporaryDirectory() as base:
        jd, j_jd = os.path.join(base, "wal"), os.path.join(base, "j_wal")
        jbptt = api.checkpointed_bptt(_body, interval=INTERVAL, slots=SLOTS,
                                      engine=engine, storage=storage,
                                      journal_dir=jd, device="cpu")
        with pytest.raises(Exception):
            with faults.inject(plan) as inj:
                gets = _record_gets(inj)
                jbptt(*_inputs())
        j_jbptt = j_api.checkpointed_bptt(
            _j_body, interval=INTERVAL, slots=SLOTS, engine=engine,
            storage=storage, journal_dir=j_jd)
        with pytest.raises(Exception):
            with _j_inject(plan, gets) as j_gets:
                j_jbptt(*_j_inputs())
        _assert_same_fetches(plan, gets, j_gets)
        recovered = _recovered(make_backend, jd)
        assert recovered == _recovered(j_storage.make_backend, j_jd)
        params, c0, xs = _inputs()
        v, g = api.resume_offloaded(bptt.chain_spec, params, (c0, xs),
                                    journal_dir=jd, interval=INTERVAL,
                                    slots=SLOTS, engine=engine,
                                    storage=storage, device="cpu")
        stats = api.last_stats()
        assert float(v) == float(v_ref)
        assert _tree_equal(g, g_ref), "resume diverged from fault-free run"
        jp, jc, jx = _j_inputs()
        j_api.resume_offloaded(j_jbptt.chain_spec, jp, (jc, jx),
                               journal_dir=j_jd, interval=INTERVAL,
                               slots=SLOTS, engine=engine, storage=storage)
        j_stats = j_api.last_stats()
        for name in COUNTERS:
            assert getattr(stats, name) == getattr(j_stats, name), name
        return recovered, stats


@pytest.mark.parametrize("k", range(M + 1))   # every boundary + final state
@pytest.mark.parametrize("engine,storage", PATHS)
def test_forward_kill_at_every_boundary(engine, storage, k):
    """Writer death at the k-th Level-2 store: resume replays from the
    last durable boundary — cost <= one interval — then runs one full
    reverse sweep; the stats are the JAX package's and the plan model's."""
    (keys, cur), st = _crash_then_resume(engine, storage,
                                         FaultPlan(kill_writer_at_store=k))
    plan = api.last_plan()
    assert st.replayed_advances <= INTERVAL
    durable = sorted(b for b in keys if isinstance(b, int))
    b_star = 0
    for seg in plan.segments:
        if seg.begin in durable:
            b_star = seg.begin
        else:
            break
    pos = b_star
    if cur is not None and cur[0] == "forward":
        pos = plan.cursor_position(plan.cursor("forward", cur[1]))
    assert st.replayed_advances == max(0, pos - b_star)
    assert st.advances == (T - b_star) + \
        _reverse_advances(plan, engine, M - 1)
    assert st.backwards == T
    # resume stores only what was not yet durable (+ the final state)
    assert st.l2_stores == (M - len(durable)) + 1
    assert st.l2_prefetches == M


@pytest.mark.parametrize("j", range(M))       # every reverse boundary fetch
@pytest.mark.parametrize("engine,storage", PATHS)
def test_reverse_crash_at_every_boundary(engine, storage, j):
    """Fetch failure during the reverse sweep: resume restarts mid-sweep
    at the journaled cursor — zero forward replay, no Level-2 stores, and
    exactly the not-yet-reversed segments' plan-model advances."""
    (keys, cur), st = _crash_then_resume(engine, storage,
                                         FaultPlan(fail_get_at=j))
    plan = api.last_plan()
    assert cur is not None and cur[0] == "reverse"
    j_start = cur[1]
    assert 0 <= j_start < M
    assert st.replayed_advances == 0
    assert st.advances == _reverse_advances(plan, engine, j_start)
    assert st.backwards == sum(seg.length
                               for seg in plan.segments[:j_start + 1])
    assert st.l2_stores == 0
    assert st.l2_prefetches == j_start + 1


def test_resume_under_different_inputs_falls_back_to_fresh():
    """A stale journal is never resumed under different params: the BEGIN
    record's input fingerprint detects the mismatch and the call runs
    fresh."""
    params, c0, xs = _inputs()
    params2 = {"W": params["W"] * 1.5}
    bptt = api.checkpointed_bptt(_body, interval=INTERVAL, slots=SLOTS,
                                 device="cpu")
    v2_ref, g2_ref = bptt(params2, c0, xs)
    with tempfile.TemporaryDirectory() as base:
        jd = os.path.join(base, "wal")
        jbptt = api.checkpointed_bptt(_body, interval=INTERVAL, slots=SLOTS,
                                      journal_dir=jd, device="cpu")
        with pytest.raises(Exception):
            with faults.inject(FaultPlan(fail_get_at=0)):
                jbptt(params, c0, xs)       # crash mid-reverse under params
        v, g = api.resume_offloaded(bptt.chain_spec, params2, (c0, xs),
                                    journal_dir=jd, interval=INTERVAL,
                                    slots=SLOTS, device="cpu")
        assert float(v) == float(v2_ref)
        assert _tree_equal(g, g2_ref), \
            "stale journal leaked into a different-input gradient"
        st = api.last_stats()
        assert st.replayed_advances == 0
        assert st.advances == T + _reverse_advances(api.last_plan(),
                                                    "compiled", M - 1)


@pytest.mark.parametrize("engine,storage", PATHS)
def test_fault_free_journaled_accounting(engine, storage):
    """A fault-free journaled run does the full plan-model work with zero
    replay, bit-identical to the unjournaled transform, and leaves a
    cleanly completed journal."""
    _, (v_ref, g_ref), _ = _baseline(engine)
    with tempfile.TemporaryDirectory() as base:
        jd = os.path.join(base, "wal")
        jbptt = api.checkpointed_bptt(_body, interval=INTERVAL, slots=SLOTS,
                                      engine=engine, storage=storage,
                                      journal_dir=jd, device="cpu")
        v, g = jbptt(*_inputs())
        st = api.last_stats()
        assert float(v) == float(v_ref) and _tree_equal(g, g_ref)
        assert st.replayed_advances == 0
        assert st.advances == T + _reverse_advances(api.last_plan(), engine,
                                                    M - 1)
        assert st.l2_stores == M + 1   # boundaries + the final state
        keys, cur = _recovered(make_backend, jd)
        assert cur == ("done", -1) and keys == ()


def _fingerprint_trees(seed):
    rng = np.random.default_rng(seed)
    return [
        # insertion order differs from the sorted order JAX flattens in
        {"w_out": rng.standard_normal((40, 33)).astype(np.float32),
         "b": np.float32(0.5) * np.ones((), np.float32),
         "a": rng.standard_normal(3000).astype(np.float32)},
        (rng.standard_normal((2, 4)).astype(np.float32),
         [np.arange(5000, dtype=np.int32)]),
        {"tokens": rng.integers(0, 96, (4, 33)).astype(np.int32),
         "mask": rng.integers(0, 2, (4, 33)).astype(np.int64)},
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_input_fingerprint_is_the_reference_s(seed):
    """``_input_fingerprint`` gives the JAX package's digest for the same
    fp32 and int inputs (and for bf16 through its raw bits), so a journal
    begun by one names the same inputs as the other."""
    trees = _fingerprint_trees(seed)
    ours = fe._input_fingerprint(*pytree.tree_map(torch.as_tensor, trees))
    jax.config.update("jax_enable_x64", True)
    try:
        ref = j_fe._input_fingerprint(*jax.tree_util.tree_map(jnp.asarray,
                                                              trees))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ours == ref
    assert fe._input_fingerprint(*trees) == ref   # numpy leaves too
    bf = np.random.default_rng(seed).standard_normal((3, 700)).astype(
        np.float32)
    assert fe._input_fingerprint(
        torch.as_tensor(bf).to(torch.bfloat16)) == \
        j_fe._input_fingerprint(jnp.asarray(bf).astype(jnp.bfloat16))
    trees[0]["a"][1500] += 1.0     # a change in the middle slice
    assert fe._input_fingerprint(
        *pytree.tree_map(torch.as_tensor, trees)) != ours


def test_tt_probe_stores_through_the_journal(monkeypatch, tmp_path):
    """With ``journal_dir=`` the autotuner's ``T_T`` probe stores through
    the journaled backend's ``put`` (a STORE record, then the inner put),
    as the JAX package's probe does, and both tuners key the schedule on
    the journaled store; the §3 rule is unchanged."""
    from repro.api.autotune import AutoTuner as JTuner

    keys = {"port": [], "ref": []}
    for name, cls in (("port", JournaledStorage),
                      ("ref", j_storage.JournaledStorage)):
        def put(self, key, tree, real=cls.put, name=name):
            keys[name].append(key)
            return real(self, key, tree)

        monkeypatch.setattr(cls, "put", put)
    tuner, j_tuner = api.AutoTuner(), JTuner()
    api.checkpointed_bptt(_body, journal_dir=str(tmp_path / "p"),
                          tuner=tuner, device="cpu")(*_inputs())
    tune = api.last_tune()
    j_api.checkpointed_bptt(_j_body, journal_dir=str(tmp_path / "r"),
                            tuner=j_tuner)(*_j_inputs())
    j_tune = j_api.last_tune()
    for name, t, tn in (("port", tune, tuner), ("ref", j_tune, j_tuner)):
        probes = [k for k in keys[name]
                  if isinstance(k, tuple) and k[0] == "__autotune__"]
        assert t.source == "measured" and t.t_t > 0
        assert len(probes) == 1 + tn.repeats, name
        assert any("JournaledStorage" in key for key in tn._cache), name


# ---------------------------------------------------------------------------
# a journal writer that lags the reverse sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["compiled", "interpreted"])
def test_reverse_crash_with_a_lagging_journal_resumes_exact(monkeypatch,
                                                            engine):
    """The journal writer is held back until the reverse sweep has reversed
    a second segment (adding it into the gradient accumulator in place),
    then the run crashes: the cursor written after the first segment must
    hold the adjoint as it was when enqueued, or the resume counts the
    second segment twice."""
    bptt, (v_ref, g_ref), _ = _baseline(engine)
    gate = threading.Event()
    real_put_cursor = JournaledStorage.put_cursor

    def lagging_put_cursor(self, cursor, *, sync=True):
        if cursor.phase == "reverse":
            gate.wait(10.0)
        return real_put_cursor(self, cursor, sync=sync)

    runner_cls = CompiledSegmentRunner if engine == "compiled" \
        else InterpretedSegmentRunner
    real_reverse = runner_cls.reverse
    calls = []

    def crashing_reverse(self, x_b, adjoint, seg, slots, stats):
        out = real_reverse(self, x_b, adjoint, seg, slots, stats)
        calls.append(seg.begin)
        if len(calls) == 2:
            gate.set()
            raise RuntimeError("crash after the second reverse segment")
        return out

    with tempfile.TemporaryDirectory() as base:
        jd = os.path.join(base, "wal")
        jbptt = api.checkpointed_bptt(_body, interval=INTERVAL, slots=SLOTS,
                                      engine=engine, journal_dir=jd,
                                      device="cpu")
        with monkeypatch.context() as m:
            m.setattr(JournaledStorage, "put_cursor", lagging_put_cursor)
            m.setattr(runner_cls, "reverse", crashing_reverse)
            with pytest.raises(RuntimeError, match="second reverse"):
                jbptt(*_inputs())
        keys, cur = _recovered(make_backend, jd)
        assert cur == ("reverse", M - 2)   # after the first segment
        params, c0, xs = _inputs()
        v, g = api.resume_offloaded(bptt.chain_spec, params, (c0, xs),
                                    journal_dir=jd, interval=INTERVAL,
                                    slots=SLOTS, engine=engine,
                                    device="cpu")
        assert float(v) == float(v_ref)
        assert _tree_equal(g, g_ref), \
            "the journaled adjoint held a later segment's gradient"


# ---------------------------------------------------------------------------
# runner="fused" on lstm-paper SMOKE (the fused kernels' plain versions)
# ---------------------------------------------------------------------------

L_I, L_S = 8, 4
L_M = j_base.SMOKE_SHAPE.seq_len // L_I
L_COUNTERS = ("advances", "backwards", "replayed_advances", "l2_stores",
              "l2_prefetches")
_LSTM = {}


def _lstm():
    """SMOKE weights and batch (from the JAX package's seeded init), the
    port's fault-free journaled fused gradient (bit-equal to the
    unjournaled one) and the JAX package's compiled-runner gradient."""
    if not _LSTM:
        cfg = j_get_config("lstm-paper", smoke=True)
        jparams = j_get_model(cfg).init(jax.random.PRNGKey(0))
        tok = np.array(j_make_batch(cfg, j_base.SMOKE_SHAPE,
                                    seed=0)["tokens"])
        ref = {k: np.asarray(v) for k, v in jparams.items()}
        model = get_model(get_config("lstm-paper", smoke=True))
        inputs = (params_from_numpy(ref, device="cpu"),
                  {"tokens": torch.as_tensor(tok)})
        plain = api.value_and_grad_offloaded(
            model.train_loss, interval=L_I, slots=L_S, runner="fused",
            device="cpu")(*inputs)
        with tempfile.TemporaryDirectory() as base:
            journaled = api.value_and_grad_offloaded(
                model.train_loss, interval=L_I, slots=L_S, runner="fused",
                device="cpu", journal_dir=os.path.join(base, "wal"))(*inputs)
        assert float(plain[0]) == float(journaled[0])
        assert _tree_equal(plain[1], journaled[1])
        j_vg = j_api.value_and_grad_offloaded(
            j_get_model(cfg).train_loss, interval=L_I, slots=L_S,
            runner="compiled")
        j_loss, j_grads = j_vg({k: jnp.asarray(v) for k, v in ref.items()},
                               {"tokens": jnp.asarray(tok)})
        _LSTM.update(model=model, inputs=inputs, ref=ref, tok=tok,
                     fault_free=journaled, j_model=j_get_model(cfg),
                     j_loss=float(j_loss),
                     j_grads={k: np.asarray(g) for k, g in j_grads.items()})
    return _LSTM


@pytest.mark.parametrize("plan", [FaultPlan(kill_writer_at_store=k)
                                  for k in range(L_M + 1)]
                         + [FaultPlan(fail_get_at=j) for j in range(L_M)],
                         ids=[f"kill{k}" for k in range(L_M + 1)]
                         + [f"get{j}" for j in range(L_M)])
def test_fused_lstm_smoke_crash_and_resume(plan):
    lstm = _lstm()
    loss, grads = lstm["fault_free"]
    np.testing.assert_allclose(float(loss), lstm["j_loss"], rtol=1e-5)
    for k, g in lstm["j_grads"].items():
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=k)
    kw = {"interval": L_I, "slots": L_S}
    with tempfile.TemporaryDirectory() as base:
        jd, j_jd = os.path.join(base, "wal"), os.path.join(base, "j_wal")
        vg = api.value_and_grad_offloaded(
            lstm["model"].train_loss, runner="fused", device="cpu",
            journal_dir=jd, **kw)
        with pytest.raises(Exception) as ei:
            with faults.inject(plan) as inj:
                gets = _record_gets(inj)
                vg(*lstm["inputs"])
        assert faults.is_storage_fault(ei.value)
        j_params = {k: jnp.asarray(v) for k, v in lstm["ref"].items()}
        j_batch = {"tokens": jnp.asarray(lstm["tok"])}
        with pytest.raises(Exception):
            with _j_inject(plan, gets) as j_gets:
                j_api.value_and_grad_offloaded(
                    lstm["j_model"].train_loss, runner="compiled",
                    journal_dir=j_jd, **kw)(j_params, j_batch)
        _assert_same_fetches(plan, gets, j_gets)
        keys, cur = _recovered(make_backend, jd)
        assert (keys, cur) == _recovered(j_storage.make_backend, j_jd)
        r_loss, r_grads = api.resume_offloaded(
            lstm["model"].train_loss, *lstm["inputs"], journal_dir=jd,
            runner="fused", device="cpu", **kw)
        stats, l_plan = api.last_stats(), api.last_plan()
        assert float(r_loss) == float(loss)
        assert _tree_equal(r_grads, grads), "fused resume diverged"
        assert stats.replayed_advances <= L_I
        j_api.resume_offloaded(lstm["j_model"].train_loss, j_params,
                               j_batch, journal_dir=j_jd,
                               runner="compiled", **kw)
        j_stats = j_api.last_stats()
        for name in L_COUNTERS:
            assert getattr(stats, name) == getattr(j_stats, name), name
        # the fused kernels ran each segment the resume advanced (from the
        # end of the contiguous durable prefix) and each it reversed
        advanced = 0
        if cur is None or cur[0] == "forward":
            start = 0
            for seg in l_plan.segments:
                if seg.begin in keys:
                    start = seg.sid
                else:
                    break
            advanced = L_M - start
        assert stats.fused_segments == advanced + stats.l2_prefetches
