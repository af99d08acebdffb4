"""The port's load generator, ladder autotuner, SLO classes and tenant
lanes (``serving/loadgen.py``, ``serving/autotune.py``,
``serving/scheduler.py``) on the CPU.

Traces, bucket DPs and plans are held exactly equal to the JAX package's
for the same inputs (both are numpy and the standard library); the
non-sharded cases of ``tests/test_sharded.py`` run on the port. The
scheduler cases bound counts and order, not wall time under load.
"""

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.serving import autotune as jax_autotune
from marl_distributedformation_tpu.serving import loadgen as jax_loadgen
from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.serving import (
    SLO_BATCH,
    SLO_INTERACTIVE,
    BackpressureError,
    BucketedPolicyEngine,
    MicroBatchScheduler,
    TraceRecorder,
    autotune_ladder,
    max_rate_at_slo,
    plans_equivalent,
    replay_recorder,
    run_load,
    synthetic_trace,
)
from marl_distributedformation_tpu_torch.serving.autotune import (
    choose_buckets,
    choose_window_ms,
    padded_cost,
)
from marl_distributedformation_tpu_torch.serving.loadgen import (
    load_trace,
    save_trace,
)
from marl_distributedformation_tpu_torch.serving.scheduler import (
    _ClassedQueue,
    _Request,
    _TenantAdmission,
)

OBS_DIM = 6


def _make_policy(seed=0):
    model = MLPActorCritic(OBS_DIM, hidden=(8, 8),
                           generator=torch.Generator().manual_seed(seed))
    return LoadedPolicy(model.eval())


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


# -- parity with the JAX package --------------------------------------------

TRACES = [
    dict(duration_s=20.0, rate_rps=40.0, seed=3, batch_fraction=0.2),
    dict(duration_s=2.0, rate_rps=200.0, seed=3,
         size_mix=((1, 0.5), (8, 0.3), (512, 0.2))),
    dict(duration_s=5.0, rate_rps=30.0, seed=1, batch_fraction=0.3),
    dict(duration_s=3.0, rate_rps=120.0, seed=9,
         size_mix=((1, 0.2), (3, 0.2), (9, 0.2), (40, 0.2), (100, 0.2))),
]


def _same_trace(a, b):
    assert np.array_equal(a.inter_arrival_s, b.inter_arrival_s)
    assert np.array_equal(a.sizes, b.sizes)
    assert a.slo_classes == b.slo_classes


@pytest.mark.parametrize("kw", TRACES)
def test_synthetic_trace_equals_the_jax_package(kw):
    _same_trace(synthetic_trace(**kw), jax_loadgen.synthetic_trace(**kw))


@pytest.mark.parametrize("kw", TRACES)
@pytest.mark.parametrize("tune", [
    dict(p95_target_ms=50.0),
    dict(p95_target_ms=50.0, mesh_divisor=4, sharded_min_rows=64),
    dict(p95_target_ms=20.0, max_rungs=3, mesh_divisor=2,
         sharded_min_rows=100),
    dict(p95_target_ms=50.0, max_rungs=2, fill_fraction=0.25),
])
def test_autotune_plan_equals_the_jax_package(kw, tune):
    trace = synthetic_trace(**kw)
    port = autotune_ladder(trace, **tune)
    ref = jax_autotune.autotune_ladder(
        jax_loadgen.synthetic_trace(**kw), **tune)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for buckets in [(1, 8, 64, 512), port.buckets, (4, 16)]:
        assert padded_cost(trace.sizes, buckets) == jax_autotune.padded_cost(
            trace.sizes, buckets)


@pytest.mark.parametrize("max_rungs,divisor,min_top", [
    (1, 1, None), (3, 1, None), (4, 1, 1024), (4, 8, None), (6, 2, 700),
])
def test_choose_buckets_equals_the_jax_package(max_rungs, divisor, min_top):
    sizes = np.random.default_rng(max_rungs).integers(1, 600, size=300)
    assert choose_buckets(sizes, max_rungs, divisor, min_top) == (
        jax_autotune.choose_buckets(sizes, max_rungs, divisor, min_top))


@pytest.mark.parametrize("rate", [0.0, 10.0, 100.0, 10_000.0])
def test_choose_window_equals_the_jax_package(rate):
    for fill in (1, 32, 256):
        assert choose_window_ms(rate, 3.5, fill, 50.0) == (
            jax_autotune.choose_window_ms(rate, 3.5, fill, 50.0))


# -- the earned ladder (tests/test_sharded.py) -------------------------------


def test_autotuner_is_deterministic_given_a_fixed_trace():
    t1 = synthetic_trace(20.0, 40.0, seed=3, batch_fraction=0.2)
    t2 = synthetic_trace(20.0, 40.0, seed=3, batch_fraction=0.2)
    kw = dict(p95_target_ms=50.0, mesh_divisor=4, sharded_min_rows=64)
    p1 = autotune_ladder(t1, **kw)
    p2 = autotune_ladder(t1, **kw)
    p3 = autotune_ladder(t2, **kw)
    assert p1 == p2 == p3
    assert all(b % 4 == 0 for b in p1.sharded_buckets)
    assert set(p1.sharded_buckets) | set(p1.replicated_buckets) == set(
        p1.buckets)
    assert p1.expected_occupancy_pct >= p1.baseline_occupancy_pct


def test_choose_buckets_dp_is_exactly_minimal():
    sizes = np.array([1, 1, 1, 2, 7, 7, 9, 30, 30, 64], np.int64)
    got = choose_buckets(sizes, max_rungs=3)
    cands = sorted(set(int(s) for s in sizes))
    best = min(
        padded_cost(sizes, combo + (cands[-1],))
        for r in range(0, 3)
        for combo in itertools.combinations(cands[:-1], r)
    )
    assert padded_cost(sizes, got) == best
    assert len(got) <= 3 and max(got) == 64


def test_choose_window_caps_at_slo_fraction_and_shrinks_with_rate():
    slow = choose_window_ms(10.0, 1.0, fill_rows=32, p95_target_ms=50.0)
    fast = choose_window_ms(10_000.0, 1.0, fill_rows=32, p95_target_ms=50.0)
    assert slow == pytest.approx(0.2 * 50.0)
    assert 0.0 < fast < slow


def test_trace_roundtrip_and_rate_scaling(tmp_path):
    trace = synthetic_trace(5.0, 30.0, seed=1, batch_fraction=0.3)
    path = tmp_path / "trace.jsonl"
    save_trace(trace, path)
    back = load_trace(path)
    assert np.allclose(back.inter_arrival_s, trace.inter_arrival_s)
    assert np.array_equal(back.sizes, trace.sizes)
    assert back.slo_classes == trace.slo_classes
    _same_trace(back, jax_loadgen.load_trace(path))
    doubled = trace.scaled_to_rate(trace.offered_rps * 2)
    assert doubled.offered_rps == pytest.approx(trace.offered_rps * 2)
    assert np.array_equal(doubled.sizes, trace.sizes)
    with pytest.raises(ValueError, match="positive"):
        trace.scaled_to_rate(0.0)


def test_autotuner_zeroes_the_dedicated_lanes_window():
    trace = synthetic_trace(2.0, 200.0, seed=3,
                            size_mix=((1, 0.5), (8, 0.3), (512, 0.2)))
    filled = autotune_ladder(trace, p95_target_ms=50.0, mesh_divisor=2,
                             sharded_min_rows=512)
    assert filled.sharded_buckets and min(filled.sharded_buckets) == 512
    assert filled.sharded_window_ms == 0.0
    partial = autotune_ladder(trace, p95_target_ms=50.0, mesh_divisor=2,
                              sharded_min_rows=100)
    assert partial.sharded_buckets and min(partial.sharded_buckets) > 100
    assert partial.sharded_window_ms == partial.window_ms > 0.0


def test_trace_recorder_replays_through_the_autotuner(tmp_path):
    rec = TraceRecorder(capacity=64)
    assert rec.to_trace() is None and not rec.save(tmp_path / "t.jsonl")
    for i in range(100):
        rec.record(1 + (i % 3) * 7, SLO_BATCH if i % 5 == 0 else
                   SLO_INTERACTIVE)
    assert len(rec) == 64 and rec.recorded_total == 100
    trace = rec.to_trace()
    assert trace.inter_arrival_s[0] == 0.0 and len(trace) == 64
    assert rec.save(tmp_path / "t.jsonl")
    assert np.array_equal(load_trace(tmp_path / "t.jsonl").sizes, trace.sizes)
    assert replay_recorder(rec, 50.0, min_requests=100) is None
    plan = replay_recorder(rec, 50.0, min_requests=32)
    assert plan is not None and set(plan.buckets) <= {1, 8, 15}
    assert plans_equivalent(plan, plan)
    assert plans_equivalent(None, None) and not plans_equivalent(plan, None)
    with pytest.raises(ValueError, match="at least one gap"):
        TraceRecorder(capacity=1)


def test_open_loop_replay_measures_a_live_scheduler():
    """run_load against a real engine: every request completes, the report
    carries per-size percentiles, and the SLO bisection finds a nonzero
    sustainable rate under a generous target."""
    engine = BucketedPolicyEngine(_make_policy(), buckets=(1, 8))
    recorder = TraceRecorder()
    with MicroBatchScheduler(engine, window_ms=0.0,
                             trace_recorder=recorder) as sched:
        engine.act(_obs(1))
        engine.act(_obs(8))
        trace = synthetic_trace(0.4, 150.0, seed=2,
                                size_mix=((1, 0.7), (8, 0.3)))
        rep = run_load(sched, trace, (OBS_DIM,), seed=2)
        assert rep.submitted == len(trace)
        assert rep.ok == rep.submitted
        assert rep.ok + rep.rejected + rep.timed_out + rep.failed == (
            rep.submitted)
        assert rep.p95_ms > 0.0
        assert set(rep.per_size_p95_ms) <= {1, 8}
        assert rep.meets(p95_target_ms=10_000.0, max_loss=0.0)
        assert recorder.recorded_total == len(trace)
        best, reports = max_rate_at_slo(
            sched, (OBS_DIM,), p95_target_ms=500.0, lo_rps=20.0,
            hi_rps=80.0, probe_duration_s=0.25, iterations=1, seed=2,
            size_mix=((1, 0.7), (8, 0.3)),
        )
        assert best >= 20.0
        assert len(reports) >= 2
        assert set(reports[0].to_dict()) >= {"p95_ms", "loss_fraction",
                                              "per_size_p95_ms"}


# -- SLO classes (tests/test_sharded.py) --------------------------------------


def _req(slo, tag, model_id=None):
    return _Request(
        obs=np.full((1, OBS_DIM), float(tag), np.float32),
        deterministic=True, future=Future(), enqueued=time.perf_counter(),
        timeout_s=None, slo_class=slo, model_id=model_id,
    )


def test_classed_queue_orders_interactive_first_fifo_within_class():
    q = _ClassedQueue(maxsize=8)
    b1, b2 = _req(SLO_BATCH, 1), _req(SLO_BATCH, 2)
    i1, i2 = _req(SLO_INTERACTIVE, 3), _req(SLO_INTERACTIVE, 4)
    for r in (b1, b2, i1, i2):
        assert q.put_nowait(r) is None
    assert [q.get_nowait() for _ in range(4)] == [i1, i2, b1, b2]
    with pytest.raises(queue.Empty):
        q.get_nowait()
    with pytest.raises(queue.Empty):
        q.get(timeout=0.01)


def test_classed_queue_preempts_newest_batch_never_interactive():
    q = _ClassedQueue(maxsize=3)
    b1, b2, i1 = (_req(SLO_BATCH, 1), _req(SLO_BATCH, 2),
                  _req(SLO_INTERACTIVE, 3))
    for r in (b1, b2, i1):
        assert q.put_nowait(r) is None
    i2 = _req(SLO_INTERACTIVE, 4)
    assert q.put_nowait(i2) is b2
    with pytest.raises(queue.Full):
        q.put_nowait(_req(SLO_BATCH, 5))
    assert q.put_nowait(_req(SLO_INTERACTIVE, 6)) is b1
    with pytest.raises(queue.Full):
        q.put_nowait(_req(SLO_INTERACTIVE, 7))
    assert q.qsize() == 3


class _GatedEngine:
    """Engine stub whose first dispatch blocks until released, tagging
    dispatch order by the obs fill value."""

    max_bucket = 8

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.order = []
        self.params = []

    def plan(self, n):
        return [self.max_bucket]

    def act(self, obs, deterministic=True, nn_params=None):
        self.entered.set()
        assert self.release.wait(30.0)
        self.order.append(int(obs[0, 0]))
        self.params.append(nn_params)
        return np.zeros((obs.shape[0], 2), np.float32)

    def compile_counts(self):
        return {8: 0}


def test_scheduler_preempts_batch_for_interactive_under_backpressure():
    engine = _GatedEngine()
    with MicroBatchScheduler(engine, max_queue=3, window_ms=0.0) as sched:
        blocker = sched.submit(np.full((1, OBS_DIM), 99.0, np.float32),
                               timeout_s=30.0)
        assert engine.entered.wait(10.0)
        batch_futs = [
            sched.submit(np.full((1, OBS_DIM), 200.0 + i, np.float32),
                         timeout_s=30.0, slo_class="batch")
            for i in range(3)
        ]
        inter_futs = [
            sched.submit(np.full((1, OBS_DIM), 100.0 + i, np.float32),
                         timeout_s=30.0)
            for i in range(2)
        ]
        preempted = [f for f in batch_futs if f.done()]
        assert len(preempted) == 2
        for f in (batch_futs[2], batch_futs[1]):
            assert isinstance(f.exception(0), BackpressureError)
        assert sched.metrics.preempted_total == 2
        engine.release.set()
        blocker.result(30.0)
        for f in inter_futs:
            f.result(30.0)
        batch_futs[0].result(30.0)
    assert engine.order[0] == 99
    assert engine.order[1:3] == [100, 101]
    assert engine.order[3] == 200


# -- tenant lanes --------------------------------------------------------------


def test_tenant_admission_bounds_and_preempts_per_lane():
    q = _TenantAdmission(["a", "b"], maxsize=2)
    a1, a2 = _req(SLO_BATCH, 1, "a"), _req(SLO_BATCH, 2, "a")
    assert q.put_nowait(a1) is None and q.put_nowait(a2) is None
    with pytest.raises(queue.Full):
        q.put_nowait(_req(SLO_BATCH, 3, "a"))
    b1 = _req(SLO_INTERACTIVE, 4, "b")
    assert q.put_nowait(b1) is None  # lane b's budget is untouched
    a_i = _req(SLO_INTERACTIVE, 5, "a")
    assert q.put_nowait(a_i) is a2  # preemption stays within lane a
    assert q.lane_depth("a") == 2 and q.lane_depth("b") == 1
    # Interactive anywhere ahead of batch anywhere, lanes round-robin.
    assert [q.get_nowait() for _ in range(3)] == [a_i, b1, a1]
    with pytest.raises(queue.Empty):
        q.get_nowait()


class _LaneRegistry:
    def __init__(self, params, step):
        self._params, self._step = params, step
        self.batch_lock = threading.Lock()
        self.swap_count = 0

    def active(self):
        return self._params, self._step


def test_tenant_lanes_answer_with_their_own_params():
    """Each lane's group carries its lane's snapshot through the batch
    barrier; the engine copies it in when the lane changes, and one rung
    serves both lanes."""
    pol_a, pol_b = _make_policy(0), _make_policy(5)
    engine = BucketedPolicyEngine(pol_a, buckets=(8,))
    lanes = {"a": _LaneRegistry(pol_a.params, 10),
             "b": _LaneRegistry(pol_b.params, 20)}
    with pytest.raises(ValueError, match="not both"):
        MicroBatchScheduler(engine, registry=lanes["a"], registries=lanes)
    obs = _obs(3, seed=1)
    ref = {"a": pol_a.predict(obs)[0], "b": pol_b.predict(obs)[0]}
    with MicroBatchScheduler(engine, registries=lanes, window_ms=5.0) as s:
        with pytest.raises(ValueError, match="requires model_id"):
            s.submit(obs)
        with pytest.raises(ValueError, match="unknown model_id"):
            s.submit(obs, model_id="c")
        futs = [(mid, s.submit(obs, model_id=mid))
                for mid in ("a", "b", "a", "b", "b", "a")]
        for mid, fut in futs:
            res = fut.result(timeout=30)
            assert res.model_id == mid
            assert res.model_step == lanes[mid].active()[1]
            np.testing.assert_allclose(res.actions, ref[mid], rtol=1e-5,
                                       atol=1e-6)
        assert s.lane_queue_depth("a") == 0
    assert engine.compile_counts() == {8: 1}
