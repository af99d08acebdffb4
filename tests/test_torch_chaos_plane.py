"""The port's chaos plane (``marl_distributedformation_tpu_torch/chaos``):
the plane cases of ``tests/test_chaos.py`` on the port, seeded schedules
record for record equal to the JAX package's, and the scheduler's
``scheduler.dispatch`` seam (a crash there is a worker death with a flight
record)."""

import json
import time

import numpy as np
import pytest

from marl_distributedformation_tpu.chaos.plane import (
    INJECTION_POINTS as JAX_POINTS,
    FaultSchedule as JaxFaultSchedule,
)
from marl_distributedformation_tpu_torch.chaos import (
    FAULT_KINDS,
    INJECTION_POINTS,
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    InjectedFault,
    SimulatedCrash,
    fault_point,
    get_fault_plane,
    set_fault_plane,
)


@pytest.fixture
def plane():
    fresh = FaultPlane(enabled=True)
    previous = set_fault_plane(fresh)
    yield fresh
    set_fault_plane(previous)


def test_disabled_plane_is_a_noop():
    plane = FaultPlane(enabled=False)
    plane.arm(FaultSchedule([FaultSpec("stream.poll", "raise", 1)]))
    for _ in range(5):
        plane.hit("stream.poll")
    assert plane.fired == []
    assert plane.pending() == 1
    assert get_fault_plane().enabled is False


def test_schedule_deterministic_from_seed_and_kind_coverage():
    a = FaultSchedule.from_seed(42, faults=25)
    b = FaultSchedule.from_seed(42, faults=25)
    assert json.dumps(a.record()) == json.dumps(b.record())
    assert len(a) == 25
    assert {s.kind for s in a.specs} == set(FAULT_KINDS)
    c = FaultSchedule.from_seed(43, faults=25)
    assert json.dumps(a.record()) != json.dumps(c.record())


def test_schedule_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSchedule([FaultSpec("stream.poll", "meteor", 1)])
    with pytest.raises(ValueError, match="cannot express"):
        FaultSchedule([FaultSpec("checkpoint.write", "raise", 1)])
    with pytest.raises(ValueError, match="duplicate fault cell"):
        FaultSchedule([
            FaultSpec("stream.poll", "raise", 1),
            FaultSpec("stream.poll", "delay", 1),
        ])
    with pytest.raises(ValueError, match="cannot arm"):
        FaultSchedule.from_seed(0, faults=10_000)


def test_fault_fires_at_exact_hit(plane):
    plane.arm(FaultSchedule([FaultSpec("stream.poll", "raise", 3)]))
    plane.hit("stream.poll")
    plane.hit("stream.poll")
    with pytest.raises(InjectedFault):
        plane.hit("stream.poll")
    plane.hit("stream.poll")
    assert [f["at_hit"] for f in plane.fired_record()] == [3]


def test_every_kind_fires_as_declared(plane, tmp_path):
    target = tmp_path / "f.bin"
    target.write_bytes(bytes(range(64)))
    plane.arm(FaultSchedule([
        FaultSpec("scheduler.dispatch", "crash", 1),
        FaultSpec("checkpoint.write", "enospc", 1),
        FaultSpec("gate.eval", "delay", 1, seconds=0.01),
        FaultSpec("checkpoint.post_rename", "bitflip", 1),
    ]))
    with pytest.raises(SimulatedCrash):
        fault_point("scheduler.dispatch")
    with pytest.raises(OSError, match="No space left"):
        fault_point("checkpoint.write")
    t0 = time.perf_counter()
    fault_point("gate.eval")
    assert time.perf_counter() - t0 >= 0.01
    fault_point("checkpoint.post_rename", path=target)
    assert target.read_bytes() != bytes(range(64))
    assert plane.pending() == 0 and len(plane.fired) == 4


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
@pytest.mark.parametrize("kw", [
    {"faults": 25},
    {"faults": 8, "max_hit": 3, "delay_s": 0.05, "wedge_s": 0.5},
    {"faults": 5, "kinds": ("crash", "delay"),
     "windows": {"scheduler.dispatch": 2, "fleet.barrier": 2}},
])
def test_from_seed_records_equal_the_jax_package(seed, kw):
    assert INJECTION_POINTS == JAX_POINTS
    port = FaultSchedule.from_seed(seed, **kw)
    ref = JaxFaultSchedule.from_seed(seed, **kw)
    assert port.record() == ref.record()
    assert [s.record() for s in port.specs] == [s.record() for s in ref.specs]


def test_scheduler_dispatch_seam_crash_is_a_worker_death(plane, tmp_path):
    """A crash armed at ``scheduler.dispatch`` kills the worker thread
    outside the per-batch backstop, with a ``scheduler_worker_death``
    flight record; ``fail_queued`` then fails the orphaned futures and
    ``restart`` brings a fresh worker up."""
    import torch

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.obs import (
        FlightRecorder,
        Tracer,
        set_tracer,
    )
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
        MicroBatchScheduler,
    )
    from marl_distributedformation_tpu_torch.serving.scheduler import (
        SchedulerStopped,
    )

    tracer = Tracer(flightrec=FlightRecorder(tmp_path / "fr"))
    previous = set_tracer(tracer)
    try:
        model = MLPActorCritic(4, hidden=(8,),
                               generator=torch.Generator().manual_seed(0))
        engine = BucketedPolicyEngine(LoadedPolicy(model), buckets=(8,))
        plane.arm(FaultSchedule([FaultSpec("scheduler.dispatch", "crash",
                                           3)]))
        sched = MicroBatchScheduler(engine, window_ms=0.0).start()
        deadline = time.time() + 10.0
        while sched.alive and time.time() < deadline:
            time.sleep(0.01)
        assert not sched.alive
        (dump,) = tracer.flightrec.dumps()
        payload = json.loads(dump.read_text())
        assert payload["trigger"] == "scheduler_worker_death"
        assert "SimulatedCrash" in payload["context"]["error"]
        orphan = sched.submit(np.zeros((1, 4), np.float32))
        sched.fail_queued()
        with pytest.raises(SchedulerStopped):
            orphan.result(timeout=5)
        sched.restart()
        assert sched.alive
        res = sched.submit(np.zeros((2, 4), np.float32)).result(timeout=30)
        assert res.actions.shape == (2, 2)
        sched.stop()
    finally:
        set_tracer(previous)
