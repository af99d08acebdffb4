"""The port's elastic capacity loop (``serving/elastic``) on the CPU, held
against the JAX package.

- ``CapacityController.decide()`` on one recorded window (the same arrival
  times and sizes injected into both packages' ``TraceRecorder``) equals
  JAX's ``CapacityDecision.to_dict()`` exactly, for windows that earn a
  replicated-only split, a sliced one, and one too thin to decide.
- JAX's ``tests/test_elastic.py`` cases run on the port's fleet (two
  device slots on the CPU device): a re-split under a mixed-size storm
  loses no request, keeps served steps monotonic, drains then retires the
  old replicas, and a program-ledger census diff shows every build after
  the fleet's warm-up was a prewarm's (none on the request path); the
  hysteresis gate skips an equivalent plan; a thin window decides nothing;
  a headroom refusal and an armed ``elastic.prewarm`` fault keep the old
  split serving. Bounds are on counts and invariants, not on timing.

Every test runs on a fresh metrics registry, tracer, program ledger and
fault plane, restored after it.
"""

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

import jax
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
)
from marl_distributedformation_tpu.serving import (
    CapacityController as JaxController,
    TraceRecorder as JaxRecorder,
)
from marl_distributedformation_tpu.serving.fleet import (
    FleetReloadCoordinator as JaxCoordinator,
    FleetRouter as JaxRouter,
)
from marl_distributedformation_tpu_torch.chaos import (
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    get_fault_plane,
    set_fault_plane,
)
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    Tracer,
    set_registry,
    set_tracer,
)
from marl_distributedformation_tpu_torch.obs.ledger import (
    ProgramLedger,
    get_ledger,
    set_ledger,
)
from marl_distributedformation_tpu_torch.serving import (
    CapacityController,
    CapacityDecision,
    TraceRecorder,
)
from marl_distributedformation_tpu_torch.serving.fleet import (
    FleetReloadCoordinator,
    FleetRouter,
    warmup_fleet,
)

OBS_DIM = 6
HIDDEN = (8, 8)
CPU2 = ["cpu", "cpu"]  # two device slots time-sharing the CPU


@pytest.fixture(autouse=True)
def private_planes():
    registry, tracer = set_registry(MetricsRegistry()), set_tracer(Tracer())
    ledger = set_ledger(ProgramLedger(enabled=True))
    plane = set_fault_plane(FaultPlane())
    yield
    get_fault_plane().enabled = False
    set_registry(registry)
    set_tracer(tracer)
    set_ledger(ledger)
    set_fault_plane(plane)


def _make_policy(seed=0):
    model = MLPActorCritic(OBS_DIM, act_dim=2, hidden=HIDDEN,
                           generator=torch.Generator().manual_seed(seed))
    return LoadedPolicy(model.eval())


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


def _elastic_fleet(tmp_path, min_requests=16):
    """A 2-replica fleet on two CPU slots with the recorder wired, warm,
    plus its coordinator and controller (JAX's storm fixture)."""
    recorder = TraceRecorder()
    router = FleetRouter(_make_policy(), devices=CPU2, buckets=(1, 8),
                         window_ms=0.0, trace_recorder=recorder)
    router.start()
    warmup_fleet(router, (OBS_DIM,))
    coordinator = FleetReloadCoordinator(str(tmp_path), router)
    controller = CapacityController(
        router, coordinator, row_shape=(OBS_DIM,), p95_target_ms=50.0,
        min_requests=min_requests, drain_timeout_s=5.0,
    )
    recorder.clear()  # warm-up traffic is not a capacity signal
    return recorder, router, controller


def _drive(router, sizes, outcomes, steps, seed=0):
    """One request a size; every accepted future must resolve (the
    no-lost-request pin), successes record (t_done, step)."""
    futures = [router.submit(_obs(n, seed=seed + i), timeout_s=5.0)
               for i, n in enumerate(sizes)]
    for f in futures:
        try:
            result = f.result(timeout=15.0)
        except FutureTimeout:
            # A RequestTimeout is a TimeoutError too: typed, not hung.
            outcomes.append("hung" if not f.done() else "RequestTimeout")
            continue
        except Exception as e:  # noqa: BLE001 — a typed failure resolved
            outcomes.append(type(e).__name__)
            continue
        outcomes.append("ok")
        steps.append((time.perf_counter(), int(result.model_step)))


# ---------------------------------------------------------------------------
# decide() against JAX's
# ---------------------------------------------------------------------------


def _window(sizes, seed):
    """``(arrival time, rows, slo class)`` samples: a seeded Poisson-ish
    arrival process over ``sizes``."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1 / 200.0, len(sizes)))
    return [(float(ti), int(n), "interactive") for ti, n in zip(t, sizes)]


WINDOWS = {
    "interactive": [1, 2, 4, 8, 1, 1, 2, 4] * 6,
    "storm": [32, 64, 48, 32, 64, 16, 1, 8] * 6,
    "big": [64, 128, 256, 64, 128, 256] * 8,
    "thin": [4, 8, 2],
}


@pytest.mark.parametrize("window", list(WINDOWS))
def test_decide_equals_jax(window, tmp_path):
    policy = _make_policy()
    jax_policy = JaxLoadedPolicy(
        {"params": params_to_jax(policy.params, "MLPActorCritic")["params"]},
        model_kwargs={"hidden": HIDDEN})
    samples = _window(WINDOWS[window], seed=len(window))
    jax_rec, rec = JaxRecorder(), TraceRecorder()
    jax_rec._ring.extend(samples)
    rec._ring.extend(samples)
    jax_router = JaxRouter(jax_policy, devices=jax.local_devices()[:2],
                           buckets=(1, 8), trace_recorder=jax_rec)
    router = FleetRouter(policy, devices=CPU2, buckets=(1, 8),
                         trace_recorder=rec)
    kw = dict(row_shape=(OBS_DIM,), p95_target_ms=50.0, min_requests=16)
    want = JaxController(jax_router, JaxCoordinator(str(tmp_path), jax_router),
                         **kw).decide()
    got = CapacityController(router, FleetReloadCoordinator(str(tmp_path),
                                                            router),
                             **kw).decide()
    if want is None:
        assert got is None
        return
    assert isinstance(got, CapacityDecision)
    assert got.to_dict() == want.to_dict()


# ---------------------------------------------------------------------------
# JAX's tests/test_elastic.py on the port's fleet
# ---------------------------------------------------------------------------


def test_resplit_under_mixed_storm(tmp_path):
    recorder, router, controller = _elastic_fleet(tmp_path)
    ledger = get_ledger()
    outcomes, steps = [], []
    try:
        _drive(router, [32, 64, 48, 32, 64, 16] * 3, outcomes, steps)
        boot_indices = {r.index for r in router.replicas}
        stop = threading.Event()

        def _pump():
            batch = 0
            while not stop.is_set():
                _drive(router, [32, 8, 64, 1], outcomes, steps,
                       seed=100 + batch)
                batch += 1

        pump = threading.Thread(target=_pump, daemon=True)
        pump.start()
        try:
            report = controller.step()
        finally:
            stop.set()
            pump.join(timeout=30.0)
        assert report is not None and report["committed"], report
        assert "hung" not in outcomes, outcomes
        assert outcomes and all(o == "ok" for o in outcomes), outcomes
        ordered = [s for _, s in sorted(steps, key=lambda x: x[0])]
        assert all(b >= a for a, b in zip(ordered, ordered[1:])), ordered
        assert report["retired_total"] == len(boot_indices)
        assert report["drained_clean"] == report["retired_total"], report
        live = {r.index for r in router.replicas}
        assert live.isdisjoint(boot_indices), (live, boot_indices)
        assert max(max(r.engine.buckets) for r in router.replicas) >= 32
        # Census diff: every new program is a prewarm's, and serving the
        # storm after the commit built nothing.
        assert report["prewarm_compiles"] >= 1, report
        assert len(ledger.entries()) == report["prewarm_programs_after"]
        post = []
        _drive(router, [64, 32, 8, 1, 48], post, [], seed=999)
        assert all(o == "ok" for o in post), post
        assert len(ledger.entries()) == report["prewarm_programs_after"]
        for counts in router.compile_counts().values():
            assert all(c <= 1 for c in counts.values()), counts
        # Hysteresis: the same mix replayed against the split it earned is
        # not a decision.
        recorder.clear()
        _drive(router, [32, 64, 48, 32, 64, 16] * 3, [], [])
        controller.step()
        recorder.clear()
        more = []
        _drive(router, [32, 64, 48, 32, 64, 16] * 3, more, [])
        assert all(o == "ok" for o in more), more
        skipped = controller.snapshot()["elastic_resplits_skipped"]
        assert controller.step() is None
        assert controller.snapshot()["elastic_resplits_skipped"] == skipped + 1
    finally:
        router.stop()


def test_thin_window_decides_nothing(tmp_path):
    recorder, router, controller = _elastic_fleet(tmp_path)
    try:
        outcomes = []
        _drive(router, [4, 8, 2], outcomes, [])
        assert all(o == "ok" for o in outcomes)
        assert len(recorder) < controller.min_requests
        assert controller.step() is None
        assert controller.snapshot()["elastic_resplits_committed"] == 0
    finally:
        router.stop()


def test_headroom_refusal_keeps_old_split(tmp_path):
    recorder, router, controller = _elastic_fleet(tmp_path)
    controller.headroom_bytes = 1.0  # nothing fits next to the fleet
    try:
        _drive(router, [32, 64] * 10, [], [])
        decision = controller.decide()
        assert decision is not None
        report = controller.apply(decision)
        assert report["skipped"] == "headroom" and not report["committed"]
        outcomes = []
        _drive(router, [8, 1], outcomes, [])
        assert all(o == "ok" for o in outcomes)
    finally:
        router.stop()


def test_prewarm_fault_aborts_round_old_split_serves(tmp_path):
    recorder, router, controller = _elastic_fleet(tmp_path)
    plane = get_fault_plane()
    try:
        _drive(router, [32, 64] * 10, [], [])
        plane.arm(FaultSchedule([FaultSpec("elastic.prewarm", "raise", 1)]))
        plane.enabled = True
        report = controller.step()
        assert report is not None and not report["committed"], report
        assert "prewarm aborted" in report.get("error", ""), report
        assert controller.snapshot()["elastic_resplits_aborted"] == 1.0
        outcomes = []
        _drive(router, [8, 1, 32], outcomes, [])
        assert all(o == "ok" for o in outcomes), outcomes
        assert all(tuple(r.engine.buckets) == (1, 8) for r in router.replicas)
    finally:
        plane.enabled = False
        router.stop()


def test_resplit_onto_a_slice_serves_big_requests_there(tmp_path):
    """A big-rung storm earns a split with a dp=2 slice over the two
    device slots: the slice is prewarmed (one build a row block a rung),
    committed, and serves the big requests; the commit's retire seam and
    the barrier stay clean."""
    recorder, router, controller = _elastic_fleet(tmp_path, min_requests=24)
    try:
        _drive(router, [64, 128, 256, 64, 128, 256] * 5, [], [])
        report = controller.step()
        assert report is not None and report["committed"], report
        assert report["decision"]["sharded_buckets"], report
        assert router.sharded_replica is not None
        assert router.sharded_replica.engine.mesh.shape == {"dp": 2}
        outcomes, steps = [], []
        _drive(router, [256, 1, 128], outcomes, steps)
        assert outcomes == ["ok"] * 3, outcomes
        by_index = router.compile_counts()
        assert by_index[router.sharded_replica.index] == dict.fromkeys(
            router.sharded_replica.engine.buckets, 1)
        assert report["pause_ms"] >= 0.0
    finally:
        router.stop()


def test_serve_cli_elastic_bench(capsys):
    """``--elastic-bench`` with bench.py's arguments (a shorter duration's
    bisection) on the CPU: the storm re-split commits, the measured storm
    builds no program, one build a rung, and the report carries every key
    of the JAX bench's."""
    import json

    from marl_distributedformation_tpu_torch import serve as serve_cli
    from test_torch_sharded import jax_report_keys

    rc = serve_cli.main([
        "--init-policy", "MLPActorCritic", "--obs-dim", "8", "--hidden",
        "64,64", "--elastic-bench", "--replicas", "2", "--duration", "2.0",
        "--load-rps", "120", "--slo-p95-ms", "80", "--slo-iterations", "1",
        "--device", "cpu",
    ])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, report
    missing = jax_report_keys("_run_elastic_bench") - set(report)
    assert not missing, missing
    assert report["elastic_resplits_committed"] >= 1
    assert report["elastic_storm_new_programs"] == 0
    assert report["elastic_prewarm_compiles"] >= 1
    assert report["max_compiles_per_rung"] == 1
