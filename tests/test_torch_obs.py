"""The port's tracing spine (``marl_distributedformation_tpu_torch/obs``):
the tracer and flight-recorder cases of ``tests/test_obs.py`` on the port,
and the snapshot and flight-record JSON keys against the JAX package's."""

import json
import threading

from marl_distributedformation_tpu.obs import (
    FlightRecorder as JaxFlightRecorder,
    Tracer as JaxTracer,
)
from marl_distributedformation_tpu_torch.obs import (
    TRACE_HEADER,
    FlightRecorder,
    Tracer,
    configure,
    get_tracer,
    new_trace_id,
    sanitize_trace_id,
    set_tracer,
)


def test_span_event_recording_and_snapshot_order():
    tr = Tracer(ring_size=64)
    with tr.span("outer", trace_id="t1", step=7):
        tr.event("inside", trace_id="t1")
    recs = tr.snapshot()
    assert [r["kind"] for r in recs] == ["span", "event"]
    span, event = recs
    assert event["name"] == "inside" and event["trace_id"] == "t1"
    assert span["name"] == "outer" and span["attrs"] == {"step": 7}
    assert span["duration_s"] >= 0.0
    assert span["t0"] <= event["t0"] <= span["t1"]


def test_ring_bounds_memory_under_sustained_load():
    tr = Tracer(ring_size=32)

    def hammer():
        for i in range(50 * 32):
            tr.event("tick", i=i)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    hammer()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    recs = tr.snapshot()
    assert len(recs) <= 32 * (5 + 8)
    assert all(r["attrs"]["i"] >= 50 * 32 - 32 for r in recs)


def test_recycled_thread_ident_keeps_dead_threads_records():
    tr = Tracer(ring_size=16)

    def record_once(i):
        tr.event("worker", i=i)

    t = threading.Thread(target=record_once, args=(-1,))
    t.start()
    t.join()
    for i in range(8):
        t2 = threading.Thread(target=record_once, args=(i,))
        t2.start()
        t2.join()
    names = [r["attrs"]["i"] for r in tr.snapshot()]
    assert -1 in names and all(i in names for i in range(8))
    for i in range(30):
        t3 = threading.Thread(target=record_once, args=(100 + i,))
        t3.start()
        t3.join()
    assert len(tr._retired) <= 8


def test_disabled_tracer_runs_body_but_records_nothing():
    tr = Tracer(enabled=False)
    ran = []
    with tr.span("s"):
        ran.append(True)
    tr.event("e")
    tr.add_span("a", 0.0, 1.0)
    assert ran == [True]
    assert tr.snapshot() == []


def test_add_span_backdated_via_epoch_anchor():
    tr = Tracer()
    epoch_start = tr.epoch_anchor - 10.0
    tr.add_span("backdated", tr.epoch_to_mono(epoch_start),
                tr.epoch_to_mono(epoch_start + 2.5), trace_id="t")
    (rec,) = tr.snapshot()
    assert abs(rec["t0"] - epoch_start) < 1e-6
    assert abs(rec["duration_s"] - 2.5) < 1e-6


def test_trace_id_hygiene():
    assert TRACE_HEADER == "X-Trace-Id"
    assert len(new_trace_id()) == 16
    assert new_trace_id() != new_trace_id()
    assert sanitize_trace_id("  abc-DEF_1.2  ") == "abc-DEF_1.2"
    assert sanitize_trace_id(None) is None
    assert sanitize_trace_id("") is None
    assert sanitize_trace_id('bad"quote') is None
    assert sanitize_trace_id("new\nline") is None
    assert sanitize_trace_id("µé¹abc") is None
    assert sanitize_trace_id("a" * 200) == "a" * 64


def test_global_registry_configure_and_swap(tmp_path):
    original = get_tracer()
    private = Tracer(ring_size=8)
    try:
        assert set_tracer(private) is original
        assert get_tracer() is private
        configure(enabled=False, ring_size=4,
                  flightrec_dir=str(tmp_path / "fr"))
        assert private.enabled is False and private.ring_size == 4
        assert isinstance(private.flightrec, FlightRecorder)
        configure(flightrec_dir="")
        assert private.flightrec is None
    finally:
        set_tracer(original)
    assert get_tracer() is original


def test_flight_recorder_dumps_prunes_and_survives_failure(tmp_path):
    rec = FlightRecorder(tmp_path / "fr", last_n=4, max_files=3)
    tr = Tracer(ring_size=16, flightrec=rec)
    for i in range(10):
        tr.event("tick", i=i)
    for k in range(5):
        path = tr.incident("circuit_break", replica=k)
        assert path is not None and path.exists()
    dumps = rec.dumps()
    assert len(dumps) == 3
    payload = json.loads(dumps[-1].read_text())
    assert payload["trigger"] == "circuit_break"
    assert payload["context"] == {"replica": 4}
    assert 0 < len(payload["records"]) <= 4
    assert not list((tmp_path / "fr").glob(".*tmp"))
    assert tr.incidents_total == 5
    # A restarted process resumes the sequence instead of overwriting.
    again = FlightRecorder(tmp_path / "fr", last_n=4, max_files=3)
    assert again.dump("x", tr).name.endswith("0006.json")


def test_incident_dumps_context_even_when_tracing_disabled(tmp_path):
    rec = FlightRecorder(tmp_path / "fr", last_n=8)
    tr = Tracer(enabled=False, flightrec=rec)
    path = tr.incident("rollback_trip", trace_id="t9", from_step=300)
    assert path is not None
    payload = json.loads(path.read_text())
    assert payload["trace_id"] == "t9"
    assert payload["context"]["from_step"] == 300
    assert payload["records"] == []


def test_incident_never_raises():
    class BrokenRecorder:
        def dump(self, *a, **k):
            raise OSError("disk full")

    tr = Tracer(flightrec=BrokenRecorder())
    assert tr.incident("scheduler_worker_death", error="boom") is None
    bare = Tracer()
    assert bare.incident("wedged_barrier_abort") is None
    assert bare.incidents_total == 1


def _record(tracer_cls, recorder_cls, out_dir):
    tr = tracer_cls(ring_size=16, flightrec=recorder_cls(out_dir, last_n=8))
    with tr.span("serve.batch", trace_id="abc", rows=3, requests=2):
        tr.event("inside", trace_id="abc")
    tr.add_span("backdated", 0.0, 1.0)
    dump = tr.dump(out_dir / "spans.json")
    path = tr.incident("scheduler_worker_death", error="boom",
                       nested={"a": [1, 2], "b": {"c": 3}})
    return tr.snapshot(), json.loads(path.read_text()), json.loads(
        dump.read_text())


def test_snapshot_and_flight_record_keys_equal_the_jax_package(tmp_path):
    port = _record(Tracer, FlightRecorder, tmp_path / "port")
    ref = _record(JaxTracer, JaxFlightRecorder, tmp_path / "jax")
    port_snap, port_flight, port_dump = port
    ref_snap, ref_flight, ref_dump = ref
    assert [sorted(r) for r in port_snap] == [sorted(r) for r in ref_snap]
    assert [(r["kind"], r["name"]) for r in port_snap] == [
        (r["kind"], r["name"]) for r in ref_snap]
    assert sorted(port_flight) == sorted(ref_flight)
    assert port_flight["context"].keys() == ref_flight["context"].keys()
    assert port_flight["context"]["nested"]["a"] == [1, 2]
    assert [sorted(r) for r in port_flight["records"]] == [
        sorted(r) for r in ref_flight["records"]]
    assert sorted(port_dump) == sorted(ref_dump)
    assert port_dump["format"] == ref_dump["format"] == "marl-obs-spans"


# ---------------------------------------------------------------------------
# Profile windows (utils/profiling.py::TraceWindow) on the CPU
# ---------------------------------------------------------------------------


def _jax_audit_keys(tmp_path):
    """The keys of the JAX package's capture audit line."""
    import jax
    import jax.numpy as jnp

    from marl_distributedformation_tpu.analysis.guards import (
        RetraceGuard as JaxRetraceGuard,
    )
    from marl_distributedformation_tpu.analysis.guards import ledgered_jit
    from marl_distributedformation_tpu.utils.profiling import (
        TraceWindow as JaxTraceWindow,
    )

    fn = ledgered_jit(lambda x: (x * 2.0).sum(), JaxRetraceGuard("t"),
                      subsystem="test", program="jax_profiled")
    window = JaxTraceWindow(str(tmp_path), enabled=True, count=1, skip=0)
    window.before_dispatch()
    window.after_dispatch(fn(jnp.ones((4,))))
    jax.block_until_ready(0)
    line = (tmp_path / "profile" / JaxTraceWindow.AUDIT_NAME).read_text()
    return set(json.loads(line.splitlines()[0]))


def test_trace_window_writes_a_trace_and_the_audit_line(tmp_path):
    import torch

    from marl_distributedformation_tpu_torch.obs import (
        ProgramLedger,
        set_ledger,
    )
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph
    from marl_distributedformation_tpu_torch.utils.profiling import (
        TraceWindow,
    )

    previous = set_ledger(ProgramLedger())
    try:
        x = torch.ones((16, 16))
        phase = PhaseGraph("profiled", lambda: torch.tanh(x @ x).sum(),
                           capture=False, subsystem="test",
                           program="profiled")
        window = TraceWindow(str(tmp_path / "port"), enabled=True, count=2,
                             skip=1)
        for _ in range(5):
            window.before_dispatch()
            phase()
            window.after_dispatch()
        window.close()  # a no-op: the window is closed
    finally:
        set_ledger(previous)
    assert window.captured and not window.active
    trace = json.loads(open(window.trace_path).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names  # the traced dispatches' ops
    lines = (tmp_path / "port" / "profile" / TraceWindow.AUDIT_NAME
             ).read_text().splitlines()
    (line,) = [json.loads(ln) for ln in lines]
    assert line["event"] == "profile_capture" and line["completed"] is True
    assert line["dispatches_traced"] == 2 and line["dispatches_skipped"] == 1
    assert line["trace_dir"].endswith("profile")
    assert line["programs"] == {"test_profiled": 2}
    assert set(line) == _jax_audit_keys(tmp_path / "jax")


def test_profile_true_traces_whole_chunks(tmp_path):
    """``profile=true`` under ``fused_chunk``: the window's unit is a
    chunk, after the two dispatches that build the phases."""
    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.obs import (
        ProgramLedger,
        set_ledger,
    )
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )

    env = EnvParams(num_agents=3, max_steps=20)
    ppo = PPOConfig(n_steps=4, batch_size=24, n_epochs=1)
    per_iter = ppo.n_steps * 4 * env.num_agents
    previous = set_ledger(ProgramLedger())
    try:
        trainer = Trainer(
            env, ppo, TrainConfig(
                num_formations=4, checkpoint=False, fused_chunk=2,
                profile=True, profile_iterations=1,
                total_timesteps=8 * per_iter, log_dir=str(tmp_path)),
            model=MLPActorCritic(env.obs_dim,
                                 generator=torch.Generator().manual_seed(0)),
            device="cpu")
        trainer.train()
    finally:
        set_ledger(previous)
    audit = tmp_path / "profile" / "capture_ledger.jsonl"
    (line,) = [json.loads(ln) for ln in audit.read_text().splitlines()]
    assert line["completed"] and line["dispatches_traced"] == 1
    # One chunk: 2 rollouts, 2 ends.
    assert line["programs"]["trainer_train_rollout"] == 2
    assert line["programs"]["trainer_train_end"] == 2


def test_profile_true_traces_a_population(tmp_path):
    """``profile=true`` on a population (``train/sweep.py``): the window
    runs at its dispatch seam as the single run's does."""
    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.obs import (
        ProgramLedger,
        set_ledger,
    )
    from marl_distributedformation_tpu_torch.train import TrainConfig
    from marl_distributedformation_tpu_torch.train.sweep import SweepTrainer

    env = EnvParams(num_agents=3, max_steps=20)
    ppo = PPOConfig(n_steps=4, batch_size=24, n_epochs=1)
    previous = set_ledger(ProgramLedger())
    try:
        sweep = SweepTrainer(
            env, ppo, TrainConfig(
                num_formations=2, checkpoint=False, profile=True,
                profile_iterations=1, total_timesteps=4 * 4 * 2 * 3,
                log_dir=str(tmp_path)),
            2, models=[MLPActorCritic(
                env.obs_dim, generator=torch.Generator().manual_seed(i))
                for i in range(2)],
            device="cpu")
        sweep.train()
    finally:
        set_ledger(previous)
    audit = tmp_path / "profile" / "capture_ledger.jsonl"
    (line,) = [json.loads(ln) for ln in audit.read_text().splitlines()]
    assert line["completed"] and line["dispatches_traced"] == 1
    assert line["programs"]["sweep_sweep_rollout"] == 1
    assert sweep.trace_window.trace_path
