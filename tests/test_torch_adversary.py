"""The port's falsifier search against the JAX package on the CPU.

Counterparts of JAX ``tests/test_adversary.py``'s search pins, and the
population against JAX's ``make_population_runner``: the port folds the P
candidates into P x M formations; given JAX's reset states and layer
draws (``test_torch_scenarios.JaxStreams``, tiled over the candidates) each
row is JAX's vmapped row up to rounding. Tolerances: population rows
within ``rtol=1e-5`` (closed-loop episode metrics); severity-0 rows against
the clean row, determinism, the build count and the knobs bitwise; the
search report's decisions (falsifier scenarios and severities, robust
families, generations) exactly, at a config whose every probe's drop sits
at least ``MARGIN`` from the tolerance, so that a rounding difference of
1e-5 cannot flip one.
"""

import functools
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.env.formation import (
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.models import MLPActorCritic as JaxMLP
from marl_distributedformation_tpu.scenarios import (
    AdversaryConfig as JaxAdversaryConfig,
    AdversarySearch as JaxAdversarySearch,
    get_scenario as jax_get_scenario,
)
from marl_distributedformation_tpu.scenarios.adversary import (
    _stack_rows as jax_stack_rows,
    make_population_runner as jax_make_population_runner,
    scenario_knobs as jax_scenario_knobs,
)
from marl_distributedformation_tpu_torch import adversarial_search as adv_cli
from marl_distributedformation_tpu_torch import robustness_matrix as rm
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.compat.convert import params_from_jax
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.scenarios import (
    AdversaryConfig,
    AdversarySearch,
    ContinuousAdversary,
    ScenarioSchedule,
    ScenarioStage,
    get_scenario,
    make_population_runner,
    registered_scenarios,
)
from marl_distributedformation_tpu_torch.scenarios import registry as preg
from marl_distributedformation_tpu_torch.scenarios.adversary import (
    FALSIFIERS_SCHEMA,
    _relative_drop,
    _stack_rows,
    scenario_knobs,
)
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.utils import config
from test_torch_env import jax_params, to_port
from test_torch_models import np_tree
from test_torch_scenarios import JaxStreams

ROOT = Path(__file__).resolve().parent.parent
ENV = EnvParams(num_agents=3, max_steps=20)
RTOL = 1e-5
MARGIN = 1e-3
SEED = 1234
BASE = tuple(n for n in registered_scenarios() if not n.startswith("adv:"))


@functools.lru_cache(maxsize=None)
def policy_pair(seed=0):
    """JAX's MLP initialised from ``seed`` and the port's holding it."""
    jmodel = JaxMLP(act_dim=ENV.act_dim)
    jvars = jmodel.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, ENV.obs_dim), jnp.float32))
    model = MLPActorCritic(ENV.obs_dim)
    model.load_state_dict(params_from_jax(np_tree(jvars), "MLPActorCritic"))
    return jmodel, jvars, model.eval()


def jax_hooks(m, seed=SEED):
    """The port program's start and layer draws from JAX's key ``seed``:
    the JAX tests' cases (an untrained policy breaks under wind) hold for
    JAX's initial states, and the port draws its own."""
    js = jax_reset_batch(jax.random.PRNGKey(seed), jax_params(ENV), m)
    return {"initial_state": to_port(js),
            "streams_factory": lambda: JaxStreams(js.key, js.steps, ENV)}


# ---------------------------------------------------------------------------
# The population program
# ---------------------------------------------------------------------------


def test_severity_zero_is_never_a_falsifier_any_scenario():
    """Every registered scenario at severity 0 reproduces the clean row
    bitwise through the folded population, so its drop is exactly 0."""
    _, _, model = policy_pair()
    run, guard = make_population_runner(model, ENV, num_formations=3,
                                        device="cpu")
    rows = [(get_scenario("clean"), 0.0)] + [
        (get_scenario(name), 0.0) for name in BASE]
    out = run(model.state_dict(), _stack_rows(rows))
    assert guard.count == 1
    for metric, values in out.items():
        assert values.shape == (len(rows),)
        for i, name in enumerate(BASE):
            assert values[i + 1].numpy().tobytes() == \
                values[0].numpy().tobytes(), (name, metric)


POPULATION = (("clean", 0.0), ("wind", 0.7), ("storm", 1.0),
              ("sensor_noise", 0.5), ("comm_dropout", 1.0),
              ("actuator_fault", 0.5), ("moving_goal", 1.0),
              ("goal_switch", 1.0), ("actuator_noise", 0.0))


@functools.lru_cache(maxsize=None)
def jax_population(m):
    jmodel, jvars, _ = policy_pair()
    run, guard = jax_make_population_runner(jmodel, jax_params(ENV), m)
    rows = [(jax_get_scenario(n), s) for n, s in POPULATION]
    out = run(jax.random.PRNGKey(SEED), jvars, jax_stack_rows(rows))
    return {k: np.asarray(v) for k, v in out.items()}, guard.count


@pytest.mark.parametrize("m", [2, 4])
def test_population_rows_match_jax(m):
    want, traces = jax_population(m)
    _, _, model = policy_pair()
    run, guard = make_population_runner(model, ENV, m, device="cpu",
                                        **jax_hooks(m))
    got = run(model.state_dict(),
              _stack_rows([(get_scenario(n), s) for n, s in POPULATION]))
    assert guard.count == traces == 1
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=RTOL,
                                   err_msg=key)
    for key in got:  # the severity-0 rows, bitwise
        assert torch.equal(got[key][-1], got[key][0]), key


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def test_search_finds_falsifier_with_positive_severity():
    _, _, model = policy_pair()
    search = AdversarySearch(model, ENV, AdversaryConfig(
        scenarios=("wind",), grid=3, generations=3, num_formations=4,
        drop_tolerance=0.02, resolution=0.001,
    ), device="cpu", **jax_hooks(4))
    report = search.search(model.state_dict(), origin="init")
    assert report["falsifiers"], "an untrained policy must break under wind"
    falsifier = report["falsifiers"][0]
    assert falsifier["scenario"] == "wind"
    assert 0.0 < falsifier["severity"] <= search.config.max_severity
    assert falsifier["drop"] > search.config.drop_tolerance
    assert falsifier["params"]["wind"][0] > 0.0
    assert report["eval_compiles"] == 1
    assert report["schema"] == FALSIFIERS_SCHEMA


def test_search_keeps_its_brackets():
    """``brackets[origin]`` holds each family's final ``(lo, hi)``: ``hi``
    the reported falsifier severity (``None`` for a robust family), ``lo``
    below it and safe when re-evaluated, ``hi`` falsified again."""
    _, _, model = policy_pair()
    search = AdversarySearch(model, ENV, AdversaryConfig(
        scenarios=("wind", "actuator_noise"), grid=3, generations=3,
        num_formations=4, drop_tolerance=0.02, resolution=0.001,
    ), device="cpu", **jax_hooks(4))
    params = model.state_dict()
    report = search.search(params, origin="init")
    brackets = search.brackets["init"]
    assert set(brackets) == {"wind", "actuator_noise"}
    falsified = {f["scenario"]: f["severity"] for f in report["falsifiers"]}
    assert "wind" in falsified
    for name, (lo, hi) in brackets.items():
        assert hi == falsified.get(name)
        if hi is None:
            assert name in report["robust"]
            continue
        assert 0.0 <= lo < hi
        clean, at_hi, at_lo = search.evaluate_cells(
            params, [("clean", 0.0), (name, hi), (name, lo)])
        assert clean == report["clean"]
        tol = search.config.drop_tolerance
        assert _relative_drop(at_hi, clean) > tol
        assert _relative_drop(at_lo, clean) <= tol
    assert search.compile_count == 1


def test_search_is_deterministic_at_fixed_seed():
    _, _, model = policy_pair()
    cfg = AdversaryConfig(scenarios=("wind", "sensor_noise"), grid=3,
                          generations=3, num_formations=4,
                          drop_tolerance=0.02)
    reports = [AdversarySearch(model, ENV, cfg, device="cpu").search(
        model.state_dict(), origin="x") for _ in range(2)]
    for rep in reports:
        rep.pop("search_seconds")
    assert json.dumps(reports[0], sort_keys=True) == json.dumps(
        reports[1], sort_keys=True)


def test_search_compiles_once_across_generations_and_checkpoints():
    _, _, model = policy_pair(0)
    _, _, other = policy_pair(1)
    search = AdversarySearch(model, ENV, AdversaryConfig(
        scenarios=("wind",), grid=3, generations=3, num_formations=4,
        drop_tolerance=0.02, resolution=0.0,
    ), device="cpu", **jax_hooks(4))
    rep_a = search.search(model.state_dict(), origin="ckpt_a")
    rep_b = search.search(other.state_dict(), origin="ckpt_b")
    assert rep_a["generations"] >= 3 and rep_b["generations"] >= 3
    assert search.compile_count == 1
    assert search.candidates_per_sec() > 0.0
    wide = MLPActorCritic(ENV.obs_dim, hidden=(8,))
    with pytest.raises(ValueError, match="different parameter"):
        search.search(wide.state_dict(), origin="ckpt_wide")
    with pytest.raises(ValueError, match="exceed the population"):
        search.evaluate_cells(model.state_dict(), [("wind", 0.1)] * 5)


SEARCH = dict(scenarios=("wind", "storm", "actuator_noise"), grid=3,
              generations=3, num_formations=4, drop_tolerance=0.05,
              resolution=0.01, seed=SEED)


def test_search_report_equals_jax():
    """The search's decisions at JAX's draws equal JAX's, every probe's
    drop at least MARGIN from the tolerance."""
    jmodel, jvars, model = policy_pair()
    theirs = JaxAdversarySearch(jmodel, jax_params(ENV),
                                JaxAdversaryConfig(**SEARCH)).search(
        jvars, origin="init")
    ours_search = AdversarySearch(model, ENV, AdversaryConfig(**SEARCH),
                                  device="cpu",
                                  **jax_hooks(SEARCH["num_formations"]))
    probes = []
    evaluate = ours_search._evaluate

    def recording(params, rows):
        values = evaluate(params, rows)
        probes.extend(values)
        return values

    ours_search._evaluate = recording
    ours = ours_search.search(model.state_dict(), origin="init")
    clean = ours["clean"]
    assert min(abs(_relative_drop(v, clean) - SEARCH["drop_tolerance"])
               for v in probes) > MARGIN
    assert ours["falsifiers"], "the config must falsify something"
    for key in ("robust", "generations", "population", "candidates",
                "scenarios", "eval_compiles", "schema"):
        assert ours[key] == theirs[key], key
    assert [(f["scenario"], f["severity"]) for f in ours["falsifiers"]] == [
        (f["scenario"], f["severity"]) for f in theirs["falsifiers"]]
    for a, b in zip(ours["falsifiers"], theirs["falsifiers"]):
        assert a["params"] == b["params"]
        np.testing.assert_allclose(a["value"], b["value"], rtol=RTOL)
    np.testing.assert_allclose(clean, theirs["clean"], rtol=RTOL)
    assert set(ours) == set(theirs)


@pytest.mark.parametrize("severity", [0.0, 0.117347, 0.5, 1.5])
def test_scenario_knobs_equal_jax(severity):
    for name in BASE:
        assert scenario_knobs(get_scenario(name), severity) == \
            jax_scenario_knobs(jax_get_scenario(name), severity), name


def test_adversary_config_refusals_equal_jax():
    for bad in ({"grid": 0}, {"generations": 0}, {"max_severity": 0.0}):
        with pytest.raises(ValueError) as ours:
            AdversaryConfig(**bad)
        with pytest.raises(ValueError) as theirs:
            JaxAdversaryConfig(**bad)
        assert str(ours.value) == str(theirs.value)
    assert AdversaryConfig() == AdversaryConfig(**{
        k: getattr(JaxAdversaryConfig(), k)
        for k in AdversaryConfig.__dataclass_fields__})


# ---------------------------------------------------------------------------
# The continuous lane and the trainer's schedule seam
# ---------------------------------------------------------------------------


def _clean_trainer(log_dir):
    schedule = ScenarioSchedule(stages=(ScenarioStage(
        rollouts=1, scenarios=("clean",), severity=0.0, severity_start=0.0),))
    return Trainer(
        ENV, PPOConfig(n_steps=5, n_epochs=1, batch_size=32),
        TrainConfig(num_formations=4, checkpoint=True, name="adv",
                    log_dir=str(log_dir)),
        model=MLPActorCritic(ENV.obs_dim,
                             generator=torch.Generator().manual_seed(0)),
        device="cpu", scenario_schedule=schedule,
    )


def test_continuous_adversary_attacks_each_checkpoint_once(tmp_path,
                                                           monkeypatch):
    """``poll_once`` attacks the newest unseen checkpoint once, records a
    corrupt file as an error without dying, and pushes a
    ``from_falsifiers`` schedule that the trainer applies at its next
    dispatch (the ``adv:`` specs it registers are taken back after)."""
    monkeypatch.setattr(preg, "_REGISTRY", dict(preg._REGISTRY))
    trainer = _clean_trainer(tmp_path / "run")
    trainer.run_iteration()
    trainer.save()
    lane = ContinuousAdversary(
        trainer.log_dir, ENV, AdversaryConfig(
            scenarios=("wind",), grid=3, generations=2, num_formations=4,
            drop_tolerance=0.02),
        device="cpu", on_schedule=trainer.request_scenario_schedule,
        feedback_rollouts=3, **jax_hooks(4))
    first = lane.poll_once()
    assert first is not None and first["falsifiers"]
    assert lane.poll_once() is None  # nothing new
    assert lane.schedules_pushed == 1
    trainer.run_iteration()
    assert any(n.startswith("adv:wind")
               for n in trainer._scenario_schedule.names)
    trainer.save()
    second = lane.poll_once()
    assert second["step"] > first["step"]
    bad = Path(trainer.log_dir) / "rl_model_999999_steps.msgpack"
    bad.write_bytes(b"not a checkpoint")
    assert lane.poll_once() is None
    assert lane.last_step == 999999 and lane.errors
    summary = lane.summary()
    assert summary["adversary_searches"] == 2
    assert summary["adversary_compiles"] == 1
    assert summary["adversary_schedules_pushed"] == 2
    assert summary["adversary_last_step"] == 999999


def test_continuous_adversary_runs_as_a_daemon(tmp_path):
    trainer = _clean_trainer(tmp_path / "run")
    trainer.run_iteration()
    trainer.save()
    lane = ContinuousAdversary(trainer.log_dir, ENV, AdversaryConfig(
        scenarios=("wind",), grid=2, generations=1, num_formations=2),
        device="cpu").run(interval_s=0.01)
    try:
        for _ in range(500):
            if lane.reports:
                break
            import time

            time.sleep(0.01)
    finally:
        lane.stop()
    assert len(lane.reports) == 1 and lane._thread is None


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def cli_root(tmp_path, monkeypatch):
    (tmp_path / "cfg").mkdir()
    shutil.copy(ROOT / "cfg" / "config.yaml", tmp_path / "cfg")
    for module in (config, rm, adv_cli):
        monkeypatch.setattr(module, "repo_root", lambda: tmp_path)
    trainer = _clean_trainer(tmp_path / "logs" / "advrun")
    trainer.run_iteration()
    trainer.save()
    trainer.run_iteration()
    trainer.save()
    return tmp_path


def test_adversarial_search_cli_emits_json(cli_root, capsys):
    report = adv_cli.main([
        "name=advrun", "num_agents_per_formation=3", "max_steps=20",
        "eval_formations=4", "scenarios=[wind,storm]", "search_grid=3",
        "search_generations=2", "search_checkpoints=2", "device=cpu",
    ])
    assert len(report["checkpoints"]) == 2
    assert report["eval_compiles"] == 1
    assert report["scenarios"] == ["wind", "storm"]
    assert report["resolved_platform"] == "cpu"
    on_disk = json.loads(Path(report["out"]).read_text())
    assert set(on_disk["searches"]) == set(report["checkpoints"])
    assert Path(report["out"]) == cli_root / "logs" / "advrun" / \
        "falsifiers.json"
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("[adversary] 2 checkpoints x 2 scenario "
                             "families, M=4, compiles=1")
    assert json.loads(out[-1])["schema"] == FALSIFIERS_SCHEMA
    with pytest.raises(SystemExit, match="registered scenarios"):
        adv_cli.main(["name=advrun", "scenarios=[windd]", "device=cpu"])


def test_adversarial_search_cli_keys_as_jax():
    import sys

    sys.path.insert(0, str(ROOT / "scripts"))
    import adversarial_search as jax_adv

    assert set(adv_cli.SEARCH_KEYS) - {"device"} == set(jax_adv.SEARCH_KEYS)
    with pytest.raises(SystemExit, match="did you mean 'search_grid'"):
        adv_cli.main(["search_gird=3", "device=cpu"])
