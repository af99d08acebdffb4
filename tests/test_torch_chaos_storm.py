"""The port's chaos storm (``marl_distributedformation_tpu_torch/
chaos_storm.py``) on the CPU, held against the repository's
``scripts/chaos_storm.py``.

- The schedules: ``build_schedule`` and ``--print-schedule`` equal the JAX
  script's for seeds 0-4 and every campaign's point set, ``--mesh`` and
  ``--elastic`` included (a pure function of the arguments: no campaign
  runs).
- The three single-host campaigns at the JAX script's tiny default, with
  the JAX tests' arguments and assertions (``tests/test_chaos.py``), and
  the ``--elastic`` campaign at its default, each run once a module; each
  report carries every key the JAX campaign writes (found by an AST scan
  of the script, no JAX campaign run).
- ``--elastic`` runs its campaign from the command line, and a campaign
  whose trainer raises leaves the fault plane disabled and empty (the
  ``--mesh`` campaign runs in ``test_torch_mesh.py``).

Every test runs on a fresh fault plane, metrics registry, tracer and
program ledger, restored after it.
"""

import ast
import json
import pathlib
import sys

import pytest

from marl_distributedformation_tpu_torch import chaos_storm
from marl_distributedformation_tpu_torch.chaos import (
    FaultPlane,
    get_fault_plane,
    set_fault_plane,
)
from marl_distributedformation_tpu_torch.obs import (
    FlightRecorder,
    MetricsRegistry,
    ProgramLedger,
    Tracer,
    set_ledger,
    set_registry,
    set_tracer,
)

SCRIPT = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
          / "chaos_storm.py")


def _jax_storm():
    """The JAX script, imported as ``tests/test_chaos.py`` imports it."""
    sys.path.insert(0, str(SCRIPT.parent))
    try:
        import chaos_storm as jax_storm
    finally:
        sys.path.pop(0)
    return jax_storm


@pytest.fixture(scope="module")
def fresh_globals(tmp_path_factory):
    """A fresh fault plane, registry, tracer and ledger for the module,
    the previous ones restored after it."""
    flightrec = FlightRecorder(tmp_path_factory.mktemp("flightrec"),
                               last_n=64)
    previous = (set_fault_plane(FaultPlane()),
                set_registry(MetricsRegistry()),
                set_tracer(Tracer(ring_size=256, flightrec=flightrec)),
                set_ledger(ProgramLedger()))
    yield
    set_fault_plane(previous[0])
    set_registry(previous[1])
    set_tracer(previous[2])
    set_ledger(previous[3])


@pytest.fixture(autouse=True)
def _isolated(fresh_globals):
    plane = get_fault_plane()
    plane.enabled = False
    plane.reset()
    yield
    assert not plane.enabled, "a campaign left the fault plane enabled"
    plane.reset()


# ---------------------------------------------------------------------------
# The schedules
# ---------------------------------------------------------------------------

# Each campaign flag, the point set its schedule draws from (None: the
# single-host campaign's) and its cap on --faults.
FLAGS = {
    "": (None, 25),
    "--mesh": (chaos_storm.TRAIN_POINTS + chaos_storm.MESH_SERVE_POINTS, 20),
    "--train": (chaos_storm.TRAIN_LANE_POINTS + chaos_storm.TRAIN_POINTS, 14),
    "--sebulba": (chaos_storm.SEBULBA_POINTS, 12),
    "--elastic": (chaos_storm.ELASTIC_POINTS, 9),
}


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("seed", range(5))
def test_schedules_and_print_schedule_equal_jax(seed, flag, capsys):
    jax_storm = _jax_storm()
    points, cap = FLAGS[flag]
    for faults in (5, cap):
        got = chaos_storm.build_schedule(seed, faults, point_names=points)
        want = jax_storm.build_schedule(seed, faults, point_names=points)
        assert got.record() == want.record(), (seed, flag, faults)
        assert len(got) == len(want)
    assert chaos_storm.WINDOWS == jax_storm.WINDOWS
    for name in ("TRAIN_POINTS", "SERVE_POINTS", "MESH_SERVE_POINTS",
                 "TRAIN_LANE_POINTS", "SEBULBA_POINTS", "ELASTIC_POINTS"):
        assert getattr(chaos_storm, name) == getattr(jax_storm, name)
    argv = ["--print-schedule", "--seed", str(seed)] + ([flag] if flag
                                                        else [])
    assert jax_storm.main(argv) == 0
    want = capsys.readouterr()
    assert chaos_storm.main(argv) == 0
    got = capsys.readouterr()
    assert got.out == want.out
    assert got.err == want.err  # the caps' notes, --mesh's included
    assert json.loads(got.out)["chaos_seed"] == seed


# ---------------------------------------------------------------------------
# The campaigns, each once a module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def storm_report(fresh_globals, tmp_path_factory):
    return chaos_storm.run_campaign(
        seed=7, faults=25, workdir=str(tmp_path_factory.mktemp("storm")),
        budget_s=150.0, wedge_s=1.2, gate_timeout_s=0.6, device="cpu",
    )


@pytest.fixture(scope="module")
def train_report(fresh_globals, tmp_path_factory):
    return chaos_storm.run_train_campaign(
        seed=2, faults=10, workdir=str(tmp_path_factory.mktemp("train")),
        device="cpu",
    )


@pytest.fixture(scope="module")
def sebulba_report(fresh_globals, tmp_path_factory):
    return chaos_storm.run_sebulba_campaign(
        seed=0, faults=12, workdir=str(tmp_path_factory.mktemp("sebulba")),
        device="cpu",
    )


@pytest.fixture(scope="module")
def elastic_report(fresh_globals):
    return chaos_storm.run_elastic_campaign(device="cpu")


def test_storm_campaign_zero_violations(storm_report):
    """JAX's ``test_chaos_storm_campaign_zero_violations``: 25 faults of
    every kind through trainer -> gate -> fleet, zero violations, finite
    MTTR, ~0 disabled-plane overhead, and the deterministic section equal
    to the seed's schedule; here also the build-once receipts."""
    report = storm_report
    assert report["chaos_invariant_violations"] == 0, report.get(
        "chaos_violations"
    )
    assert report["chaos_faults_fired"] == 25
    assert report["chaos_faults_unfired"] == 0
    assert report["resume_ok"]
    assert 0.0 < report["chaos_mttr_s"] < 60.0
    assert report["fault_plane_overhead_pct"] < 5.0
    assert report["probes_ok"] > 0
    expected = chaos_storm.build_schedule(7, 25, wedge_s=1.2)
    assert report["deterministic"] == {
        "chaos_seed": 7,
        "chaos_faults_armed": 25,
        "schedule": expected.record(),
    }
    kinds = {f["kind"] for f in expected.record()}
    assert {"crash", "wedge", "enospc", "delay"} <= kinds
    assert kinds & {"truncate", "bitflip"}  # corrupt coverage
    receipts = report["compile_receipts"]
    assert receipts["gate_matrix"] == 1
    assert sorted(receipts) == ["gate_matrix"] + [
        f"replica{r}_rung{b}" for r in (0, 1) for b in (1, 8)]
    assert set(receipts.values()) == {1}
    assert report["gate_timeouts"] >= 1


def test_train_campaign_zero_violations(train_report):
    """JAX's ``test_chaos_storm_train_campaign_zero_violations``."""
    report = train_report
    assert report["chaos_invariant_violations"] == 0, report.get(
        "chaos_violations"
    )
    assert report["chaos_faults_fired"] == 10
    assert report["chaos_faults_unfired"] == 0
    assert not report["train_halted"]
    assert report["train_recoveries"] >= 1  # seed 2 arms poison raises
    assert 0.0 < report["recovery_mttr_s"] < 60.0
    expected = chaos_storm.build_schedule(
        2, 10,
        point_names=chaos_storm.TRAIN_LANE_POINTS + chaos_storm.TRAIN_POINTS,
    )
    assert report["deterministic"] == {
        "chaos_seed": 2,
        "chaos_faults_armed": 10,
        "schedule": expected.record(),
    }
    assert report["train_compiles"] == 1


def test_sebulba_campaign_zero_violations(sebulba_report):
    report = sebulba_report
    assert report["chaos_invariant_violations"] == 0, report.get(
        "chaos_violations"
    )
    assert report["chaos_faults_fired"] == 12
    assert report["chaos_faults_unfired"] == 0
    if report["sebulba_dequeue_raises_fired"]:
        assert report["sebulba_duplicates_absorbed"] >= 1
    assert report["sebulba_actor_compiles"] == 1
    assert report["sebulba_learner_compiles"] == 1
    expected = chaos_storm.build_schedule(
        0, 12, point_names=chaos_storm.SEBULBA_POINTS)
    assert report["deterministic"]["schedule"] == expected.record()


def test_elastic_campaign_zero_violations(elastic_report):
    """The JAX campaign's invariants at its default (seed 0, 9 faults, 6
    rounds of 60 requests, the (8, 8) MLP at obs_dim 8): no request lost,
    monotonic steps, budget-1 receipts on the final replica set, at least
    2 re-splits committed, every armed fault fired."""
    report = elastic_report
    assert report["chaos_invariant_violations"] == 0, report.get(
        "chaos_violations")
    assert report["chaos_faults_fired"] == 9
    assert report["chaos_faults_unfired"] == 0
    assert report["elastic_resplits_committed"] >= 2
    assert report["elastic_prewarm_compiles"] >= 1
    assert report["requests_ok"] == report["requests_resolved"] > 0
    assert set(report["compile_receipts"].values()) == {1}
    expected = chaos_storm.build_schedule(
        0, 9, point_names=chaos_storm.ELASTIC_POINTS)
    assert report["deterministic"] == {
        "chaos_seed": 0, "chaos_faults_armed": 9,
        "schedule": expected.record()}


def _jax_report_keys(function: str) -> set:
    """Every ``report["..."] = ...`` key of ``function`` in the JAX
    script, its early-exit ``error`` (a failed bootstrap) aside."""
    tree = ast.parse(SCRIPT.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = {"deterministic"}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (isinstance(target, ast.Subscript)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "report"
                        and isinstance(target.slice, ast.Constant)):
                    keys.add(target.slice.value)
    return keys - {"error"}


@pytest.mark.parametrize("function, fixture", [
    ("run_campaign", "storm_report"),
    ("run_train_campaign", "train_report"),
    ("run_sebulba_campaign", "sebulba_report"),
    ("run_elastic_campaign", "elastic_report"),
])
def test_reports_carry_every_jax_key(function, fixture, request):
    keys = _jax_report_keys(function)
    assert len(keys) > 10
    missing = keys - set(request.getfixturevalue(fixture))
    assert not missing, missing


# ---------------------------------------------------------------------------
# Refusals and the plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag, item", [
    ("--elastic", "A12 (serving/elastic)"),
])
def test_unported_campaigns_exit_naming_their_items(flag, item, monkeypatch,
                                                    capsys):
    """Every campaign is ported: ``--elastic`` (A12's ``serving/elastic``,
    its module named in its help) runs ``run_elastic_campaign`` with the
    capped fault count on the asked-for device, prints its report and
    exits by its violations."""
    calls = []

    def campaign(**kwargs):
        calls.append(kwargs)
        return {"chaos_invariant_violations": len(calls) - 1}

    monkeypatch.setattr(chaos_storm, "run_elastic_campaign", campaign)
    assert chaos_storm.main([flag, "device=cpu"]) == 0
    assert calls[0]["faults"] == 9 and calls[0]["device"] == "cpu"
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "chaos_invariant_violations": 0}
    assert chaos_storm.main([flag, "--device", "cpu"]) == 1
    with pytest.raises(SystemExit):
        chaos_storm.main(["--help"])
    assert item.split()[1].strip("()") in capsys.readouterr().out


@pytest.mark.parametrize("campaign, cls", [
    ("run_campaign", "Trainer"),
    ("run_train_campaign", "Trainer"),
    ("run_sebulba_campaign", "SebulbaDriver"),
])
def test_plane_disabled_after_a_campaign_whose_trainer_raises(
        campaign, cls, monkeypatch, tmp_path):
    from marl_distributedformation_tpu_torch import train

    armed = []

    def boom(self):
        plane = get_fault_plane()
        armed.append((plane.enabled, plane.pending()))
        raise RuntimeError("trainer down")

    monkeypatch.setattr(getattr(train, cls), "train", boom)
    with pytest.raises(RuntimeError, match="trainer down"):
        getattr(chaos_storm, campaign)(workdir=str(tmp_path), device="cpu")
    assert armed and armed[0][0] and armed[0][1] > 0
    plane = get_fault_plane()
    assert not plane.enabled
    assert plane.pending() == 0 and not plane.fired

