"""The port's planning and cost model equal the JAX package's.

Revolve, the segment plan, chunking, interval snapping and the §3 cost
model are framework-free copies; every result must be *equal* to the
reference's over a hypothesis sweep of ``(n, I, s)``, with explicit cases
for prime ``n`` and ``n % I != 0``.
"""
import pytest
from hypothesis import given, settings, strategies as st

from repro.api import autotune as j_at
from repro.core import perfmodel as j_pm
from repro.core import revolve as j_rv
from repro.core import schedule as j_ms
from repro.core.multistage_scan import choose_interval as j_choose_interval
from repro_torch.api import autotune as t_at
from repro_torch.api import frontend as t_fe
from repro_torch.core import perfmodel as t_pm
from repro_torch.core import revolve as t_rv
from repro_torch.core import schedule as t_ms


def _actions(seq):
    return None if seq is None else tuple(
        (a.op.value, a.index, a.end) for a in seq)


def _plan(plan):
    return (plan.n, plan.interval, plan.s_l1, plan.plan_id,
            tuple((s.sid, s.begin, s.end, _actions(s.revolve))
                  for s in plan.segments),
            tuple(plan.boundaries()), tuple(plan.reverse_access_order()),
            plan.total_advances())


def _cursor(c):
    return (c.plan_id, c.n, c.interval, c.s_l1, c.phase, c.segment_index)


def _assert_plans_equal(n, interval, s):
    jp = j_ms.segment_plan(n, interval, s)
    tp = t_ms.segment_plan(n, interval, s)
    assert _plan(tp) == _plan(jp)
    for phase, idx in (("forward", 1), ("reverse", tp.num_segments - 1),
                       ("done", -1)):
        assert _cursor(tp.cursor(phase, idx)) == _cursor(jp.cursor(phase, idx))
    for seg_t, seg_j in zip(tp.segments, jp.segments):
        assert t_ms.chunk_length(seg_t.length, s) == \
            j_ms.chunk_length(seg_j.length, s)


@settings(deadline=None, max_examples=60)
@given(n=st.integers(1, 300), interval=st.integers(1, 64),
       s=st.integers(1, 20))
def test_segment_plan_equal(n, interval, s):
    _assert_plans_equal(n, interval, s)


@pytest.mark.parametrize("n,interval,s", [
    (97, 8, 4),      # prime n, uneven tail segment
    (101, 10, 3),    # prime n
    (37, 8, 4),      # n % I != 0
    (4096, 600, 16), # the chip run's pinned shape class
    (1, 1, 1),
])
def test_segment_plan_equal_explicit(n, interval, s):
    _assert_plans_equal(n, interval, s)


@settings(deadline=None, max_examples=60)
@given(n=st.integers(1, 200), s=st.integers(1, 12))
def test_revolve_equal(n, s):
    assert _actions(t_rv.revolve_schedule(n, s)) == \
        _actions(j_rv.revolve_schedule(n, s))
    assert t_rv.optimal_advances(n, s) == j_rv.optimal_advances(n, s)


@settings(deadline=None, max_examples=80)
@given(seg_len=st.integers(1, 500), s=st.integers(1, 40))
def test_chunk_length_equal(seg_len, s):
    assert t_ms.chunk_length(seg_len, s) == j_ms.chunk_length(seg_len, s)


@settings(deadline=None, max_examples=80)
@given(n=st.integers(1, 5000), target=st.integers(1, 200))
def test_snap_and_choose_interval_equal(n, target):
    assert t_at.snap_interval(n, target) == j_at.snap_interval(n, target)
    assert t_fe.choose_interval(n, target) == \
        j_choose_interval(n, target)
    assert t_at.default_slots(target) == j_at.default_slots(target)


@pytest.mark.parametrize("n,target", [(97, 8), (4096, 5), (4096, 32),
                                      (37, 32), (7919, 13)])
def test_snap_and_choose_interval_explicit(n, target):
    assert t_at.snap_interval(n, target) == j_at.snap_interval(n, target)
    assert t_fe.choose_interval(n, target) == \
        j_choose_interval(n, target)


@settings(deadline=None, max_examples=60)
@given(n=st.integers(1, 400), interval=st.integers(1, 64),
       s=st.integers(1, 16),
       t_a=st.floats(1e-6, 1e-2), t_b=st.floats(1e-6, 1e-2),
       t_t=st.floats(1e-7, 1e-1))
def test_cost_model_equal(n, interval, s, t_a, t_b, t_t):
    assert t_ms.multistage_recompute_factor(n, interval, s) == \
        j_ms.multistage_recompute_factor(n, interval, s)
    assert t_pm.optimal_interval(t_t, t_a) == j_pm.optimal_interval(t_t, t_a)
    assert t_pm.t_async(n, interval, s, t_a, t_b, t_t) == \
        j_pm.t_async(n, interval, s, t_a, t_b, t_t)


def test_h100_spec_is_the_data_sheet():
    """The port plans for the H100, not the TPU: its spec carries the data
    sheet's rates and no host-link guess."""
    import math

    assert t_at.GLOBAL_TUNER.hw is t_pm.H100
    assert t_pm.H100.hbm_bw == 3.35e12 and t_pm.H100.hbm_bytes == 80e9
    assert math.isnan(t_pm.H100.d2h_bw)
    assert t_pm.H100 != t_pm.TPU_V5E
