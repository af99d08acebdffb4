"""The port's metrics registry, exporters and telemetry endpoint against
the JAX package's (``obs/metrics.py``, ``obs/export.py``).

The registry's semantics are the JAX package's (``tests/test_metrics.py``):
per-thread shards, exact counters across threads and dead threads,
last-write-wins gauges, bounded reservoirs with nearest-rank percentiles,
the same snapshot keys. ``prometheus_exposition`` must give byte-equal
text to JAX's for the same snapshot (tolerance: none, the strings are
compared), and ``wants_prometheus`` the same verdict for every header.
The trainers record the JAX trainer's metric names.
"""

import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.obs import export as jax_export
from marl_distributedformation_tpu.obs.metrics import (
    MetricsRegistry as JaxRegistry,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    ProgramLedger,
    TelemetryServer,
    chrome_trace,
    configure_metrics,
    get_registry,
    prometheus_exposition,
    set_ledger,
    set_registry,
    wants_prometheus,
)
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (NaN|[+-]?Inf|[-+0-9.e]+)$"
)


@pytest.fixture
def private_registry():
    """A fresh process-global registry (and ledger) per test, restored
    afterwards."""
    prev = set_registry(MetricsRegistry())
    prev_ledger = set_ledger(ProgramLedger())
    try:
        yield get_registry()
    finally:
        set_registry(prev)
        set_ledger(prev_ledger)


def _record(reg):
    """The same recordings into either package's registry."""
    reg.counter("reqs_total").inc()
    reg.counter("reqs_total").inc(2.0)
    reg.gauge("depth").set(3)
    for v in (1.0, 2.0, 3.0, 10.0, 0.5, 7.0):
        reg.histogram("lat_seconds").observe(v)
    reg.record_gauges({"fleet_routed_total": 12, "note": "text"})
    return reg.snapshot()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_snapshot_keys_and_values_equal_jax():
    got, want = _record(MetricsRegistry()), _record(JaxRegistry())
    assert got == want
    assert got["reqs_total"] == 3.0 and got["lat_seconds_count"] == 6.0
    assert got["lat_seconds_p50"] == 2.0  # nearest-rank: round(2.5) == 2
    assert got["lat_seconds_p99"] == 10.0
    assert "note" not in got


def test_disabled_registry_records_nothing():
    reg = MetricsRegistry(enabled=False)
    reg.counter("c_total").inc()
    reg.gauge("g").set(1.0)
    reg.histogram("h").observe(1.0)
    reg.record_gauges({"x": 1.0})
    assert reg.snapshot() == {}
    reg.enabled = True
    reg.counter("c_total").inc()
    assert reg.snapshot() == {"c_total": 1.0}


def test_multithread_counts_are_exact_and_snapshots_consistent():
    reg = MetricsRegistry(reservoir=64)
    per_thread, n_threads = 2000, 5
    stop = threading.Event()

    def hammer(i):
        for k in range(per_thread):
            reg.counter("work_total").inc()
            reg.histogram("work_seconds").observe(float(k % 7))
            reg.gauge(f"worker{i}_progress").set(k)

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(n_threads)]
    seen = []

    def watcher():
        while not stop.is_set():
            seen.append(reg.snapshot().get("work_total", 0.0))

    w = threading.Thread(target=watcher)
    w.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    w.join()
    total = float(per_thread * n_threads)
    snap = reg.snapshot()
    assert snap["work_total"] == total
    assert snap["work_seconds_count"] == total
    assert all(v <= total for v in seen)
    assert all(b >= a for a, b in zip(seen, seen[1:]))


def test_gauge_last_write_wins_across_threads():
    reg = MetricsRegistry()
    reg.gauge("g").set(1.0)
    t = threading.Thread(target=lambda: reg.gauge("g").set(42.0))
    t.start()
    t.join()
    assert reg.snapshot()["g"] == 42.0
    reg.gauge("g").set(7.0)
    assert reg.snapshot()["g"] == 7.0


def test_many_short_lived_threads_never_lose_counts():
    """One fresh thread a write, as the checkpoint writer runs: dead
    shards fold into the retired accumulators."""
    reg = MetricsRegistry(reservoir=32)
    n_threads = 64

    def one_write(i):
        reg.counter("writes_total").inc()
        reg.histogram("write_seconds").observe(float(i))

    for i in range(n_threads):
        t = threading.Thread(target=one_write, args=(i,))
        t.start()
        t.join()
    snap = reg.snapshot()
    assert snap["writes_total"] == float(n_threads)
    assert snap["write_seconds_count"] == float(n_threads)
    assert snap["write_seconds_sum"] == float(sum(range(n_threads)))
    assert snap["write_seconds_p50"] > 0.0
    assert len(reg._shards) <= threading.active_count() + 1


def test_reservoir_resize_keeps_counter_totals():
    reg = MetricsRegistry(reservoir=8)
    reg.counter("c_total").inc(5)
    reg.reservoir = 16
    reg.counter("c_total").inc(3)
    assert reg.snapshot()["c_total"] == 8.0


def test_reservoir_bounds_percentile_window_as_jax():
    """A reservoir of 4 keeps the 4 newest samples a thread: the
    percentiles move with the window while count and sum stay exact."""
    snaps = []
    for cls in (MetricsRegistry, JaxRegistry):
        reg = cls(reservoir=4)
        for v in range(10):
            reg.histogram("h").observe(float(v))
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["h_p50"] == 8.0 and snaps[0]["h_count"] == 10.0


def test_configure_metrics_reshapes_the_global_registry(private_registry):
    reg = configure_metrics(enabled=False, reservoir=3)
    assert reg is get_registry() and not reg.enabled and reg.reservoir == 3
    configure_metrics(enabled=True)
    assert get_registry().enabled


# ---------------------------------------------------------------------------
# Exporters, byte for byte
# ---------------------------------------------------------------------------

SNAPSHOTS = {
    "registry": None,  # filled from _record
    "serving": {
        "latency_p50_ms": 1.5, "latency_p95_ms": 2.5, "latency_p99_ms": 3.5,
        "rung512_f32_sharded": 1.0, "rung512_f32_sharded_compiles": 1.0,
        "rung8_bf16_occupancy": 0.5, "replica0_queue_depth": 0.0,
        "replica1_queue_depth": 2.0,
    },
    "tenants": {
        "model_formation-a__step": 200.0,
        "model_formation-a__requests_total": 7.0,
        "model_form_b.v2__step": 100.0,
        "model_pursuit__latency_p95_ms": 2.5, "model_step": 200.0,
    },
    "ledger": {
        "program_trainer_train_rollout_flops": 1.5e9,
        "program_trainer_train_rollout_compile_seconds": 0.25,
        "program_trainer_train_rollout_dispatch_seconds_p95": 0.001,
        "program_trainer_train_rollout_dispatches_total": 30.0,
        "ledger_programs_total": 3.0,
        "device_memory_watermark_bytes": 4096.0,
    },
    "odd": {
        "nan_gauge": float("nan"), "inf_gauge": float("inf"),
        "neg_inf": float("-inf"), "1starts_with_digit": 2.0,
        "has-dash.dot": 1.0, "text": "skipped", "none": None,
    },
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
@pytest.mark.parametrize("labels", [None, {"host": 'a"b\\c\nd', "lane": "x"}])
def test_prometheus_exposition_is_byte_equal_to_jax(name, labels):
    snap = SNAPSHOTS[name] or _record(MetricsRegistry())
    got = prometheus_exposition(snap, labels=labels)
    want = jax_export.prometheus_exposition(snap, labels=labels)
    assert got == want
    for line in got.strip().splitlines():
        if not line.startswith("#"):
            assert _PROM_LINE.match(line), line


@pytest.mark.parametrize("header", [
    None, "", "*/*", "text/plain", "application/json",
    "application/json, text/plain, */*", "text/plain;q=0.5, application/json",
    "application/openmetrics-text; version=1.0.0",
    "text/plain;q=0.9, application/json;q=0.8", "text/plain;q=bogus",
])
def test_wants_prometheus_as_jax(header):
    assert wants_prometheus(header) == jax_export.wants_prometheus(header)


def test_chrome_trace_equals_jax():
    records = [
        {"kind": "span", "name": "dispatch", "thread": "main", "t0": 1.0,
         "t1": 1.5, "trace_id": "abc", "attrs": {"n": 3}},
        {"kind": "event", "name": "swap", "thread": "worker", "t0": 2.0},
        {"kind": "span", "name": "bad"},  # malformed: skipped
    ]
    assert chrome_trace(records) == jax_export.chrome_trace(records)


# ---------------------------------------------------------------------------
# TelemetryServer on loopback
# ---------------------------------------------------------------------------


def test_telemetry_server_serves_prometheus_and_json():
    reg = MetricsRegistry()
    reg.counter("ticks_total").inc(4)
    reg.gauge("train_env_steps_per_sec").set(100.0)
    srv = TelemetryServer(
        port=0, registry=reg, extra_snapshot=lambda: {"extra_gauge": 1.0}
    ).start()
    try:
        assert srv.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        for line in body.strip().splitlines():
            if not line.startswith("#"):
                assert _PROM_LINE.match(line), line
        assert "marl_ticks_total 4.0" in body
        assert "marl_extra_gauge 1.0" in body
        with urllib.request.urlopen(
            srv.url.replace("/metrics", "/metrics.json"), timeout=5
        ) as resp:
            snap = json.loads(resp.read())
        assert snap["ticks_total"] == 4.0
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(srv.url.replace("/metrics", "/nope"),
                                   timeout=5)
        assert err.value.code == 404
    finally:
        srv.stop()


def test_telemetry_server_survives_broken_extra_snapshot():
    reg = MetricsRegistry()
    reg.gauge("g").set(1.0)

    def broken():
        raise RuntimeError("boom")

    srv = TelemetryServer(port=0, registry=reg, extra_snapshot=broken).start()
    try:
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert b"marl_g 1.0" in resp.read()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# What the trainers, the writer and the ladder record
# ---------------------------------------------------------------------------

ENV = EnvParams(num_agents=3, max_steps=20)
PPO = PPOConfig(n_steps=4, batch_size=24, n_epochs=2)


def _trainer(tmp_path, **cfg):
    base = dict(num_formations=4, seed=0, name="metrics",
                log_dir=str(tmp_path / "logs"), save_freq=8)
    base.update(cfg)
    model = MLPActorCritic(ENV.obs_dim, ENV.act_dim,
                           generator=torch.Generator().manual_seed(0))
    return Trainer(ENV, PPO, TrainConfig(**base), model=model, device="cpu")


def test_fused_trainer_records_lane_metrics(private_registry, tmp_path):
    """The JAX trainer's names (``tests/test_metrics.py``): 3 chunks of 2
    iterations, drained and checkpointed by the background writer."""
    per_iter = PPO.n_steps * 4 * ENV.num_agents
    trainer = _trainer(tmp_path, fused_chunk=2, total_timesteps=6 * per_iter)
    trainer.train()
    snap = get_registry().snapshot()
    assert snap["train_iterations_total"] == 6.0
    assert snap["train_chunks_total"] == 3.0
    assert snap["train_chunk_drain_seconds_count"] == 3.0
    assert snap["train_env_steps_per_sec"] > 0.0
    assert snap["train_steps_per_sec"] > 0.0
    # One build of the iteration program (the CPU's eager phases).
    assert snap["train_compiles"] == 1.0 == trainer.retrace_guard.count
    assert snap["checkpoint_writes_total"] >= 1.0
    assert snap["checkpoint_queue_depth"] == 0.0
    assert snap["checkpoint_write_seconds_count"] >= 1.0


def test_host_loop_records_and_telemetry_off_records_nothing(
    private_registry, tmp_path
):
    per_iter = PPO.n_steps * 4 * ENV.num_agents
    _trainer(tmp_path, checkpoint=False,
             total_timesteps=3 * per_iter).train()
    snap = get_registry().snapshot()
    assert snap["train_iterations_total"] == 3.0
    assert snap["train_compiles"] == 1.0
    get_registry().enabled = False
    _trainer(tmp_path / "off", checkpoint=False,
             total_timesteps=3 * per_iter).train()
    assert get_registry().snapshot()["train_iterations_total"] == 3.0


def test_recovery_ladder_records_jax_names(private_registry, tmp_path):
    """A poisoned run: the skips, the divergence event, the rollback and
    its MTTR land under the JAX ladder's names."""
    per_iter = PPO.n_steps * 4 * ENV.num_agents
    trainer = _trainer(tmp_path, fused_chunk=2, health=True, recovery=True,
                       recovery_breach_iters=2,
                       total_timesteps=8 * per_iter)
    calls = []

    def poison(phase):
        calls.append(phase)
        if phase == "rollout" and len(calls) in (7, 10):
            trainer._poison_carry(float("nan"))

    trainer.phase_hook = poison
    trainer.train()
    snap = get_registry().snapshot()
    assert snap["train_skipped_updates_total"] >= 2.0
    assert snap["train_divergence_events_total"] >= 1.0
    assert snap["train_recoveries_total"] >= 1.0
    assert snap["train_recovery_mttr_seconds_count"] >= 1.0
    assert "train_consecutive_unhealthy" in snap
    assert np.isfinite(
        [p.detach().numpy() for p in trainer.model.parameters()][0]).all()


def test_checkpoint_gate_and_pruning_record(private_registry, tmp_path):
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        prune_checkpoints,
        quarantine_checkpoint,
        save_checkpoint,
    )

    assert save_checkpoint(tmp_path, 1, {"x": np.float32([np.nan])}) is None
    for step in (1, 2, 3):
        save_checkpoint(tmp_path, step, {"x": np.float32([step])})
    assert len(prune_checkpoints(tmp_path, 1)) == 2
    quarantine_checkpoint(tmp_path / "rl_model_3_steps.msgpack", "test")
    snap = get_registry().snapshot()
    assert snap["checkpoint_nonfinite_skipped_total"] == 1.0
    assert snap["checkpoint_pruned_total"] == 2.0
    assert snap["checkpoint_quarantined_total"] == 1.0
