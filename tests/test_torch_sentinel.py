"""The port's regression sentinel (``obs/sentinel.py``) against the JAX
package's: the same record and the same sequence of snapshots go through
both ``RegressionSentinel``s, which must agree on every trip, streak,
latch and re-arm, on ``missing``, ``summary()`` and the audit lines
(``time`` and ``flightrec`` masked). ``load_bench_record`` is held to
JAX's on ``tmp_path`` trees. A record of another platform is the one
settled divergence: the port does not use it."""

import json

import pytest

from marl_distributedformation_tpu.obs import (
    FlightRecorder as JaxFlightRecorder,
    MetricsRegistry as JaxMetricsRegistry,
    RegressionSentinel as JaxRegressionSentinel,
    Tracer as JaxTracer,
    Watch as JaxWatch,
    default_watches as jax_default_watches,
    ledger_watches as jax_ledger_watches,
    load_bench_record as jax_load_bench_record,
    recovery_watches as jax_recovery_watches,
)
from marl_distributedformation_tpu_torch.obs import (
    FlightRecorder,
    MetricsRegistry,
    RegressionSentinel,
    Tracer,
    Watch,
    default_watches,
    ledger_watches,
    load_bench_record,
    recovery_watches,
)
from marl_distributedformation_tpu_torch.obs.sentinel import (
    foreign_record_reason,
    platform_of,
)

RATE = ("rate", ("recorded_rate",), "min", 0.5)
LATENCY = ("latency_p95_ms", ("serving_fleet_p95_ms",), "max", 0.5)

# (watches, record, trip_after, snapshots): each case walks one path of the
# trip machinery.
CASES = {
    # Hysteresis, latching and re-arming (JAX's
    # test_sentinel_trips_only_after_consecutive_breaches).
    "hysteresis_latch_rearm": (
        [RATE], {"recorded_rate": 100.0}, 3,
        [{"rate": v} for v in (10, 10, 80, 10, 10, 10, 10, 90, 10, 10, 10)],
    ),
    "direction_max": (
        [LATENCY], {"serving_fleet_p95_ms": 10.0}, 1,
        [{"latency_p95_ms": v} for v in (14.0, 20.0, 20.0, 15.0, 16.0)],
    ),
    "missing_taxonomy": (
        [("a", ("absent_field",), "min", 0.5),
         ("b", ("skipped_field",), "min", 0.5),
         ("c", ("text_field",), "min", 0.5),
         ("d", ("absent_field", "good_field"), "min", 0.5)],
        {"skipped_field": "skipped", "text_field": "notanumber",
         "good_field": 4.0},
        1, [{"a": 0.0, "b": 0.0, "c": 0.0, "d": 0.0}] * 3,
    ),
    "cold_gauge_keeps_streak": (
        [RATE], {"recorded_rate": 100.0}, 2,
        [{"rate": 10.0}, {}, {}, {}, {"rate": 10.0}, {"rate": 10.0}],
    ),
    "never_observed": (
        [("fed", ("f1",), "min", 0.5), ("starved", ("f2",), "min", 0.5),
         ("unmeasurable", ("f3",), "min", 0.5)],
        {"f1": 100.0, "f2": 100.0}, 2,
        [{"fed": 90.0}, {"fed": 10.0}, {"fed": 10.0}],
    ),
    "two_watches_trip_together": (
        [RATE, LATENCY],
        {"recorded_rate": 100.0, "serving_fleet_p95_ms": 10.0}, 2,
        [{"rate": 1.0, "latency_p95_ms": 100.0}] * 3
        + [{"rate": 100.0, "latency_p95_ms": 100.0}] * 2,
    ),
}


def _pair(tmp_path, watches, record, trip_after, platform=None):
    """The JAX and the port sentinel over the same watches and record,
    each with its own registry, tracer and flight recorder."""
    out = []
    for tag, sentinel_cls, watch_cls, reg_cls, tr_cls, fr_cls, extra in (
        ("jax", JaxRegressionSentinel, JaxWatch, JaxMetricsRegistry,
         JaxTracer, JaxFlightRecorder, {}),
        ("port", RegressionSentinel, Watch, MetricsRegistry, Tracer,
         FlightRecorder, {} if platform is None else {"device": platform}),
    ):
        d = tmp_path / tag
        registry = reg_cls()
        tracer = tr_cls(flightrec=fr_cls(d, last_n=16))
        out.append(sentinel_cls(
            [watch_cls(*w) for w in watches], record=record,
            trip_after=trip_after, audit_dir=d, registry=registry,
            tracer=tracer, **extra))
    return out


def _audit(path):
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return [{**x, "time": None, "flightrec": x["flightrec"] is not None}
            for x in lines]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sentinel_matches_jax(case, tmp_path):
    watches, record, trip_after, snapshots = CASES[case]
    jax_s, port_s = _pair(tmp_path, watches, record, trip_after)
    for snap in snapshots:
        assert port_s.check(dict(snap)) == jax_s.check(dict(snap)), snap
        for w in watches:
            js, ps = jax_s._state[w[0]], port_s._state[w[0]]
            assert (ps.streak, ps.tripped) == (js.streak, js.tripped)
    assert port_s.trips == jax_s.trips
    assert port_s.missing == jax_s.missing
    assert port_s.summary() == jax_s.summary()
    assert port_s.checks_total == jax_s.checks_total == len(snapshots)
    for w in watches:
        assert port_s.limit(Watch(*w)) == jax_s.limit(JaxWatch(*w))
    trips = len(jax_s.trips)
    assert (port_s._registry.snapshot().get("sentinel_trips_total", 0.0)
            == jax_s._registry.snapshot().get("sentinel_trips_total", 0.0)
            == trips)
    for tag in ("jax", "port"):
        dumps = list((tmp_path / tag).glob("flightrec-perf_regression-*"))
        assert len(dumps) == trips, tag
    if trips:
        assert (_audit(tmp_path / "port" / "perf_incidents.jsonl")
                == _audit(tmp_path / "jax" / "perf_incidents.jsonl"))
        payload = json.loads(sorted(
            (tmp_path / "port").glob("flightrec-*"))[0].read_text())
        assert payload["trigger"] == "perf_regression"
        assert payload["context"]["gauge"] == jax_s.trips[0]["gauge"]
    else:
        assert not (tmp_path / "port" / "perf_incidents.jsonl").exists()


def test_watch_sets_and_validation_match_jax():
    for port_fn, jax_fn in ((default_watches, jax_default_watches),
                            (ledger_watches, jax_ledger_watches),
                            (recovery_watches, jax_recovery_watches)):
        for args in ((), (0.25,)):
            got = [vars(w) if hasattr(w, "__dict__") else w
                   for w in port_fn(*args)]
            want = [vars(w) if hasattr(w, "__dict__") else w
                    for w in jax_fn(*args)]
            assert got == want
    for bad in ({"direction": "up"}, {"tolerance": 0.0},
                {"bench_fields": ()}):
        kwargs = {"gauge": "g", "bench_fields": ("f",), **bad}
        with pytest.raises(ValueError) as port_err:
            Watch(**kwargs)
        with pytest.raises(ValueError) as jax_err:
            JaxWatch(**kwargs)
        assert str(port_err.value) == str(jax_err.value)


def _write(path, payload):
    path.write_text(payload if isinstance(payload, str)
                    else json.dumps(payload))


@pytest.mark.parametrize("tree", ["numeric_order", "wrapper", "unreadable",
                                  "explicit_path", "empty"])
def test_load_bench_record_matches_jax(tree, tmp_path):
    root = tmp_path / tree
    root.mkdir()
    path = None
    if tree == "numeric_order":
        _write(root / "BENCH_r9.json", {"metric": 9})
        _write(root / "BENCH_r10.json", {"metric": 10})
        _write(root / "BENCH_rx.json", {"metric": "not a record"})
    elif tree == "wrapper":
        _write(root / "BENCH_r01.json",
               {"parsed": {"train_env_steps_per_sec": 2.0}, "tail": "x"})
    elif tree == "unreadable":
        _write(root / "BENCH_r02.json", {"metric": 2})
        _write(root / "BENCH_r03.json", "{not json")
    elif tree == "explicit_path":
        _write(root / "BENCH_r05.json", {"metric": 5})
        path = root / "mine.json"
        _write(path, {"parsed": {"metric": "mine"}})
    got = load_bench_record(path, root=root)
    assert got == jax_load_bench_record(path, root=root)
    if tree == "numeric_order":
        assert got == ({"metric": 10}, root / "BENCH_r10.json")
    elif tree == "unreadable":
        assert got[0] == {"metric": 2}
    elif tree == "empty":
        assert got == ({}, None)


TPU_RECORD = {"platform": "tpu", "device": "TPU v5 lite",
              "recorded_rate": 100.0, "serving_fleet_p95_ms": 10.0}


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_a_foreign_record_is_not_used(device, tmp_path):
    """A TPU record on the card: every watch is missing, with a reason
    naming the record's device; nothing trips, while JAX's sentinel,
    which uses the record, trips."""
    _write(tmp_path / "BENCH_r02.json", {"parsed": TPU_RECORD})
    watches = [RATE, LATENCY]
    port_s = RegressionSentinel(
        [Watch(*w) for w in watches], bench_root=tmp_path, trip_after=1,
        audit_dir=tmp_path / "audit", registry=MetricsRegistry(),
        tracer=Tracer(), device=device)
    jax_s = JaxRegressionSentinel(
        [JaxWatch(*w) for w in watches], bench_root=tmp_path, trip_after=1,
        registry=JaxMetricsRegistry(), tracer=JaxTracer())
    snap = {"rate": 1.0, "latency_p95_ms": 1000.0}
    assert len(jax_s.check(dict(snap))) == 2
    for _ in range(3):
        assert port_s.check(dict(snap)) == []
    assert port_s.trips == []
    assert sorted(port_s.missing) == ["latency_p95_ms", "rate"]
    for reason in port_s.missing.values():
        assert "TPU v5 lite" in reason and "tpu record" in reason
        assert "BENCH_r02.json" in reason
    summary = port_s.summary()
    assert summary["sentinel_bench_record"] is None
    assert summary["sentinel_never_observed"] == []
    assert summary["sentinel_checks"] == 3
    assert not (tmp_path / "audit").exists()


@pytest.mark.parametrize("record, device, kind, foreign", [
    ({"platform": "gpu", "device": "NVIDIA H100 80GB HBM3"}, "cuda",
     "NVIDIA H100 80GB HBM3", False),
    ({"platform": "gpu", "device": "NVIDIA H100 80GB HBM3"}, "cuda:0",
     None, False),
    ({"platform": "gpu", "device": "NVIDIA A100-SXM4-80GB"}, "cuda",
     "NVIDIA H100 80GB HBM3", True),
    ({"platform": "cpu", "device": "cpu"}, "cuda", None, True),
    ({"platform": "cpu", "device": "cpu"}, "cpu", None, False),
    ({"platform": "tpu"}, "cpu", None, True),
    ({"recorded_rate": 1.0}, "cuda", "NVIDIA H100 80GB HBM3", False),
])
def test_foreign_record_reason(record, device, kind, foreign):
    assert platform_of(device) in ("gpu", "cpu")
    assert (foreign_record_reason(record, device, kind) is not None) \
        == foreign


def test_a_record_of_this_platform_behaves_as_jax(tmp_path):
    """A CPU record watched on the CPU is used exactly as JAX uses it."""
    record = {"platform": "cpu", "device": "cpu", "recorded_rate": 100.0}
    jax_s, port_s = _pair(tmp_path, [RATE], record, 2, platform="cpu")
    assert port_s.foreign is None
    for snap in ({"rate": 10.0},) * 3:
        assert port_s.check(dict(snap)) == jax_s.check(dict(snap))
    assert port_s.summary() == jax_s.summary()
    assert len(port_s.trips) == 1
