"""The port's program ledger against the JAX package's (``obs/ledger.py``,
the ``analysis/guards.py`` seam, the ``train`` CLI's census).

A program here is a ``PhaseGraph`` (a captured CUDA graph on the card, an
eager build on the CPU) or an eager host function under ``ledgered_call``:
one census entry a build, dispatch histograms after it, cost facts present
or explicitly unavailable, nothing when the ledger is off. The census
keeps JAX's schema (every key of JAX's, plus ``graph_nodes``) so that the
JAX package's ``load_census`` and ``scripts/program_report.py`` read the
port's file. The ``train`` CLI writes ``logs/{name}/program_ledger.json``
by default and honours ``telemetry=false`` and ``ledger=false``.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.analysis.guards import (
    RetraceGuard as JaxRetraceGuard,
)
from marl_distributedformation_tpu.analysis.guards import (
    ledgered_jit as jax_ledgered_jit,
)
from marl_distributedformation_tpu.obs.ledger import (
    ProgramLedger as JaxProgramLedger,
)
from marl_distributedformation_tpu.obs.ledger import (
    load_census as jax_load_census,
)
from marl_distributedformation_tpu.obs.ledger import (
    sanitize_key as jax_sanitize_key,
)
from marl_distributedformation_tpu.obs.ledger import (
    set_ledger as jax_set_ledger,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.analysis.guards import (
    RetraceGuard,
    ledgered_call,
    sample_device_watermark,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    TelemetryServer,
    get_registry,
    prometheus_exposition,
    set_registry,
)
from marl_distributedformation_tpu_torch.obs.ledger import (
    ANALYSIS_SOURCES,
    CENSUS_SCHEMA,
    ProgramLedger,
    get_ledger,
    load_census,
    sanitize_key,
    set_ledger,
)
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.train import cli as train_cli
from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def private_ledger():
    """A fresh process-global ledger and registry per test, restored
    afterwards."""
    previous = set_ledger(ProgramLedger(enabled=True, reservoir=64))
    prev_registry = set_registry(MetricsRegistry())
    try:
        yield get_ledger()
    finally:
        set_ledger(previous)
        set_registry(prev_registry)


def _matmul_phase(name="p", subsystem="test", **kw):
    x = torch.ones((8, 8))
    out = {}

    def fn():
        out["y"] = torch.tanh(x @ x).sum()

    return PhaseGraph(name, fn, capture=False, subsystem=subsystem,
                      program=name, signature=(x,), **kw), out


@pytest.mark.parametrize("text", ["Trainer.Train Iteration", "__x__", "???",
                                  "sebulba_sebulba_actor_rollout"])
def test_sanitize_key_as_jax(text):
    assert sanitize_key(text) == jax_sanitize_key(text)


def test_disabled_ledger_is_inert(private_ledger):
    private_ledger.enabled = False
    phase, out = _matmul_phase()
    for _ in range(3):
        phase()
    assert float(out["y"]) == pytest.approx(64.0)
    assert private_ledger.entries() == []
    assert private_ledger.snapshot() == {}
    assert private_ledger.register(name="x", subsystem="y") is None
    private_ledger.record_watermark(123.0)
    assert private_ledger.snapshot() == {}
    assert sample_device_watermark(force=True) is None


def test_phase_registers_once_a_build_then_dispatches(private_ledger):
    phase, _ = _matmul_phase("one_build")
    for _ in range(5):
        phase()
    (rec,) = private_ledger.entries()
    assert rec.key == "test_one_build" and rec.subsystem == "test"
    assert "torch.float32[8, 8]" in rec.fingerprint
    assert rec.analysis_source == "flop_counter" in ANALYSIS_SOURCES
    # One 8x8x8 matmul: 2 * 8**3 flops (the tanh and sum count nothing).
    assert rec.facts["flops"] == 2 * 8 ** 3
    assert rec.analysis_error  # the memory facts say why they are missing
    assert rec.graph_nodes is None  # an eager build
    assert rec.timings["first_dispatch_seconds"] > 0.0
    snap = private_ledger.snapshot()
    # The building call is not a latency sample.
    assert snap["program_test_one_build_dispatches_total"] == 4.0
    assert snap["program_test_one_build_dispatch_seconds_count"] == 4.0
    assert snap["ledger_programs_total"] == 1.0


def test_ledgered_call_as_ledgered_jit(private_ledger):
    """JAX's ``ledgered_jit`` receipts for an eager host program: one
    build counted and registered, later calls are dispatches."""
    guard = RetraceGuard("t", max_traces=1)
    fn = ledgered_call(lambda x: x * 2.0, guard, subsystem="test",
                       program="host")
    for _ in range(3):
        np.testing.assert_array_equal(fn(np.ones(4)), 2.0 * np.ones(4))
    assert guard.count == 1 and len(private_ledger.entries()) == 1
    snap = private_ledger.snapshot()
    assert snap["program_test_host_dispatches_total"] == 2.0


def test_watermark_keeps_the_peak(private_ledger):
    private_ledger.record_watermark(100.0)
    private_ledger.record_watermark(500.0)
    private_ledger.record_watermark(200.0, peak_bytes=300.0)
    snap = private_ledger.snapshot()
    assert snap["device_memory_bytes_in_use"] == 200.0
    assert snap["device_memory_watermark_bytes"] == 500.0
    private_ledger.record_watermark(10.0, peak_bytes=900.0)
    assert private_ledger.watermark_bytes == 900.0
    # The CPU has no device memory to sample.
    assert sample_device_watermark(force=True) is None


def _jax_census(tmp_path):
    previous = jax_set_ledger(JaxProgramLedger())
    try:
        fn = jax_ledgered_jit(lambda x: jnp.tanh(x @ x).sum(),
                              JaxRetraceGuard("t", max_traces=1),
                              subsystem="test", program="ref")
        for _ in range(3):
            fn(jnp.ones((8, 8)))
        from marl_distributedformation_tpu.obs.ledger import get_ledger as g

        g().record_watermark(1.0)
        path = g().write_census(tmp_path / "jax.json")
    finally:
        jax_set_ledger(previous)
    return json.loads(path.read_text())


def test_census_keys_equal_jax_and_jax_reads_it(private_ledger, tmp_path):
    phase, _ = _matmul_phase("ref")
    for _ in range(3):
        phase()
    private_ledger.record_watermark(1.0)
    path = private_ledger.write_census(tmp_path / "program_ledger.json")
    port = load_census(path)
    want = _jax_census(tmp_path)
    assert port["schema"] == want["schema"] == CENSUS_SCHEMA
    assert set(port) == set(want)
    assert set(port["totals"]) == set(want["totals"])
    (p,), (j,) = port["programs"], want["programs"]
    # Every key of JAX's record, and the port's graph nodes.
    assert set(p) == set(j) | {"graph_nodes"}
    assert p["key"] == j["key"] == "test_ref"
    assert p["dispatches_total"] == j["dispatches_total"] == 2.0
    # JAX's own reader and report read the port's file.
    census = jax_load_census(path)
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import program_report
    finally:
        sys.path.pop(0)
    summary = program_report.summarize(census, top=5)
    assert summary["program_count"] == 1
    assert "test_ref" in program_report.render_text(census, top=5)


def test_program_prometheus_families(private_ledger):
    phase, _ = _matmul_phase("prog", subsystem="gramm")
    for _ in range(3):
        phase()
    private_ledger.record_watermark(4096.0)
    text = prometheus_exposition(private_ledger.snapshot())
    assert 'marl_program_flops{program="gramm_prog"} 1024.0' in text
    assert "# TYPE marl_program_dispatch_seconds summary" in text
    assert ('marl_program_dispatches_total{program="gramm_prog"} 2.0'
            in text)
    assert "marl_ledger_programs_total 1.0" in text
    assert "marl_device_memory_watermark_bytes 4096.0" in text


def test_telemetry_scrape_carries_the_ledger(private_ledger):
    private_ledger.register(name="p", subsystem="s", facts={"flops": 42.0})
    snap = TelemetryServer(registry=MetricsRegistry())._snapshot()
    assert snap["program_s_p_flops"] == 42.0
    assert snap["ledger_programs_total"] == 1.0


# ---------------------------------------------------------------------------
# The registration sites
# ---------------------------------------------------------------------------

ENV = EnvParams(num_agents=3, max_steps=20)
PPO = PPOConfig(n_steps=4, batch_size=24, n_epochs=2)


def test_trainer_phases_and_samplers_register(private_ledger, tmp_path):
    """The three phase programs and the scenario sampler, as JAX's trainer
    registers its iteration and its sampler; one build receipt each."""
    from marl_distributedformation_tpu_torch.scenarios import (
        ScenarioSchedule,
        ScenarioStage,
    )

    model = MLPActorCritic(ENV.obs_dim, ENV.act_dim,
                           generator=torch.Generator().manual_seed(0))
    trainer = Trainer(
        ENV, PPO, TrainConfig(num_formations=4, checkpoint=False,
                              log_dir=str(tmp_path)),
        model=model, device="cpu",
        scenario_schedule=ScenarioSchedule(stages=(ScenarioStage(
            rollouts=8, scenarios=("clean",), severity=0.0),)),
    )
    for _ in range(2):
        trainer.run_iteration()
    assert trainer.retrace_guard.count == 1
    assert trainer._sampler_guard.count == 1
    keys = {e.key: e for e in private_ledger.entries()}
    assert set(keys) == {"trainer_train_rollout", "trainer_train_minibatch",
                         "trainer_train_end", "scenarios_scenario_sampler"}
    assert keys["trainer_train_minibatch"].facts["flops"] > 0
    snap = private_ledger.snapshot()
    assert snap["program_trainer_train_rollout_dispatches_total"] == 1.0
    steps = trainer._iteration.num_minibatch_steps
    assert (snap["program_trainer_train_minibatch_dispatches_total"]
            == 2 * steps - 1)


def test_serving_rungs_and_matrix_register(private_ledger):
    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        get_scenario,
        make_matrix_runner,
    )
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )

    model = MLPActorCritic(6, 2, hidden=(16,),
                           generator=torch.Generator().manual_seed(0))
    engine = BucketedPolicyEngine(LoadedPolicy(model.eval()), buckets=(1, 4))
    for rows in (3, 3, 1):
        engine.act(np.zeros((rows, 6), np.float32))
    keys = {e.key for e in private_ledger.entries()}
    assert keys == {"serving_act_rung1_f32", "serving_act_rung4_f32"}

    params = EnvParams(num_agents=3, max_steps=6)
    net = MLPActorCritic(params.obs_dim, params.act_dim,
                         generator=torch.Generator().manual_seed(1))
    run, guard = make_matrix_runner(net, params, 2, device="cpu")
    weights = dict(net.named_parameters())
    for severity in (0.0, 0.5):
        run(weights, get_scenario("wind").build(severity))
    assert guard.count == 1
    gate = [e for e in private_ledger.entries() if e.subsystem == "gate"]
    assert [e.key for e in gate] == ["gate_robustness_matrix_eval"]


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def cli_root(tmp_path, monkeypatch, private_ledger):
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    return tmp_path


def _run(root, *extra):
    train_cli.main(["name=obs", "device=cpu", "num_formation=2",
                    "total_timesteps=100", *extra])
    return root / "logs" / "obs"


def test_cli_writes_the_census_by_default(cli_root):
    run = _run(cli_root, "fused_chunk=2")
    census = load_census(run / "program_ledger.json")
    assert {p["key"] for p in census["programs"]} == {
        "trainer_train_rollout", "trainer_train_minibatch",
        "trainer_train_end"}
    assert jax_load_census(run / "program_ledger.json")["programs"]
    snap = get_registry().snapshot()
    assert snap["train_iterations_total"] >= 1.0


def test_cli_honours_ledger_and_telemetry_off(cli_root):
    run = _run(cli_root, "ledger=false", "telemetry=false")
    assert not (run / "program_ledger.json").exists()
    assert (run / "metrics.jsonl").exists()
    assert get_registry().snapshot() == {}
    assert not get_ledger().enabled and not get_registry().enabled
