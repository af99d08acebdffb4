"""The port's robustness matrix against the JAX package on the CPU.

The port's matrix program (``scenarios/matrix.py``) starts each cell from
JAX's reset states and takes the layers' draws from JAX's keys
(``test_torch_scenarios.JaxStreams``), so a cell is JAX's
``make_matrix_runner`` cell up to rounding. Tolerances: cell metrics
within ``rtol=1e-5`` (closed-loop episode metrics, as in
``test_torch_eval.py``); ``episodes``, the build count and the clean cell
against the port's own ``eval.run_episode_metrics`` bitwise; checkpoint
trees bitwise.
"""

import functools
import json
import shutil
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    load_checkpoint_raw as jax_load_checkpoint_raw,
)
from marl_distributedformation_tpu.env.formation import (
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.models import GNNActorCritic as JaxGNN
from marl_distributedformation_tpu.models import MLPActorCritic as JaxMLP
from marl_distributedformation_tpu.scenarios import (
    MatrixProgram as JaxMatrixProgram,
    get_scenario as jax_get_scenario,
    make_matrix_runner as jax_make_matrix_runner,
    run_matrix as jax_run_matrix,
)
from marl_distributedformation_tpu_torch import robustness_matrix as rm
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.analysis.guards import (
    RetraceError,
    RetraceGuard,
)
from marl_distributedformation_tpu_torch.compat.convert import params_from_jax
from marl_distributedformation_tpu_torch.compat.policy import (
    LoadedPolicy,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.eval import (
    policy_act_fn,
    run_episode_metrics,
)
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.scenarios import (
    MatrixProgram,
    get_scenario,
    make_matrix_runner,
    params_signature,
    run_matrix,
)
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.utils import config
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
)
from test_torch_env import jax_params, to_port
from test_torch_models import np_tree
from test_torch_scenarios import JaxStreams

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "docs/acceptance/tpu_run/rl_model_20480000_steps.msgpack"
RTOL = 1e-5
M = 4
KEY = 11
SCENARIOS = ("clean", "wind", "sensor_noise", "actuator_fault", "storm",
             "comm_dropout")
SEVERITIES = (0.0, 0.5, 1.0)
KINDS = {
    "mlp": EnvParams(num_agents=3, max_steps=5),
    "gnn": EnvParams(num_agents=8, obs_mode="knn", knn_k=2, max_steps=5),
}


@functools.lru_cache(maxsize=None)
def jax_pairs(kind):
    """Two parameter sets of one architecture in both packages:
    ``(jax model, [jax variables], port model, [port state_dicts])``."""
    params = KINDS[kind]
    obs = jnp.zeros((1, params.num_agents, params.obs_dim), jnp.float32)
    if kind == "mlp":
        jmodel, model = JaxMLP(act_dim=2), MLPActorCritic(params.obs_dim)
        name = "MLPActorCritic"
    else:
        jmodel, model = JaxGNN(k=params.knn_k), GNNActorCritic(k=params.knn_k)
        name = "GNNActorCritic"
    jvars = [jmodel.init(jax.random.PRNGKey(i), obs) for i in range(2)]
    states = [params_from_jax(np_tree(v), name) for v in jvars]
    model.load_state_dict(states[0])
    return jmodel, jvars, model.eval(), states


@functools.lru_cache(maxsize=None)
def jax_cells(kind):
    """JAX's matrix runner over the grid for both parameter sets, jitted
    once; returns the cells and JAX's trace count."""
    jmodel, jvars, _, _ = jax_pairs(kind)
    jp = jax_params(KINDS[kind])
    run, guard = jax_make_matrix_runner(jmodel, jp, num_formations=M)
    key = jax.random.PRNGKey(KEY)
    cells = [{k: float(v) for k, v in run(
        key, v, jax_get_scenario(name).build(jnp.float32(sev))).items()}
        for v in jvars for name in SCENARIOS for sev in SEVERITIES]
    return cells, guard.count


def port_program(kind, **kw):
    """The port's matrix program from JAX's reset states, the layers
    drawing JAX's draws."""
    params = KINDS[kind]
    _, _, model, _ = jax_pairs(kind)
    js = jax_reset_batch(jax.random.PRNGKey(KEY), jax_params(params), M)
    return MatrixProgram(
        model, params, num_formations=M, device="cpu",
        initial_state=to_port(js),
        streams_factory=lambda: JaxStreams(js.key, js.steps, params), **kw)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_matrix_cells_match_jax(kind):
    """6 scenarios x 3 severities x 2 parameter sets: every cell's metrics
    within rtol 1e-5 of JAX's ``make_matrix_runner``; one build in each
    package."""
    want, jax_traces = jax_cells(kind)
    _, _, _, states = jax_pairs(kind)
    program = port_program(kind)
    got = [{k: float(v) for k, v in program.run(
        s, get_scenario(name).build(np.float32(sev))).items()}
        for s in states for name in SCENARIOS for sev in SEVERITIES]
    assert program.compile_count == jax_traces == 1
    assert len(got) == len(want) == 2 * len(SCENARIOS) * len(SEVERITIES)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["episodes"] == w["episodes"] == M
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=key)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_evaluate_clean_is_the_raw_env_bitwise(kind):
    """The clean scenario at severity 0 through the matrix program equals
    ``eval.run_episode_metrics`` with no scenario, bitwise, after disturbed
    cells of another parameter set ran in the same program."""
    params = KINDS[kind]
    _, _, model, states = jax_pairs(kind)
    program = MatrixProgram(model, params, num_formations=M, device="cpu")
    program.evaluate_cells(states[1], ["storm", "goal_switch"], [1.0])
    clean = program.evaluate_clean(states[0])
    raw = run_episode_metrics(policy_act_fn(model, params), params, M,
                              device="cpu")
    assert clean == {k: float(v) for k, v in raw.items()}
    assert program.compile_count == 1


def test_check_params_refuses_another_architecture_with_jax_message():
    _, jvars, model, states = jax_pairs("mlp")
    params = KINDS["mlp"]
    wide = MLPActorCritic(params.obs_dim, hidden=(8,))
    ours = MatrixProgram(model, params, num_formations=M, device="cpu")
    ours.check_params(states[0])
    ours.check_params(states[1], origin="same")
    jwide = JaxMLP(act_dim=2, hidden=(8,)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, params.obs_dim), jnp.float32))
    theirs = JaxMatrixProgram(JaxMLP(act_dim=2), jax_params(params),
                              num_formations=M)
    theirs.check_params(jvars[0])
    with pytest.raises(ValueError) as e_ours:
        ours.check_params(wide.state_dict(), origin="ckpt_wide")
    with pytest.raises(ValueError) as e_theirs:
        theirs.check_params(jwide, origin="ckpt_wide")
    assert str(e_ours.value) == str(e_theirs.value)
    assert params_signature(states[0]) == params_signature(model)
    assert params_signature(states[0]) != params_signature(wide)


def test_matrix_runner_budget_refuses_a_second_build():
    """``make_matrix_runner``'s budget-1 guard: a parameter set of another
    signature would need a second build, which raises ``RetraceError``
    naming the program; the same signature never rebuilds."""
    params = KINDS["mlp"]
    _, _, model, states = jax_pairs("mlp")
    run, guard = make_matrix_runner(model, params, M, device="cpu")
    for s in states:
        run(s, get_scenario("wind").build(0.5))
    assert guard.count == 1
    wide = MLPActorCritic(params.obs_dim, hidden=(8,))
    with pytest.raises(RetraceError, match="robustness_matrix_eval"):
        run(wide, get_scenario("wind").build(0.5))
    counting, guard = make_matrix_runner(model, params, M, device="cpu",
                                         max_traces=None)
    counting(states[0], get_scenario("clean").build(0.0))
    counting(wide, get_scenario("clean").build(0.0))
    assert guard.count == 2


def test_retrace_guard_counts_builds_and_names_the_signature():
    guard = RetraceGuard("prog", max_traces=1)
    build = guard.wrap(lambda x: x * 2)
    assert build(torch.zeros(3)).shape == (3,)
    with pytest.raises(RetraceError, match=r"'prog' built 2 times.*float32\[4"):
        build(torch.zeros(4))

    def broken(x):
        raise ValueError("no program")

    failing = RetraceGuard("f", max_traces=1)
    with pytest.raises(ValueError):
        failing.wrap(broken)(1)
    assert failing.count == 0  # a build that raises made no program


def test_copy_batched_linear_refuses_rows_not_copy_major():
    """Over 3 copies a dense layer is one batched GEMM of the copies'
    blocks: equal blocks give equal rows bitwise, the result is
    ``F.linear``'s within rtol 1e-6 (another reduction order), and a
    leading axis of 4 rows is not 3 copy-major blocks and raises."""
    from marl_distributedformation_tpu_torch.scenarios.matrix import (
        CopyBatchedLinear,
    )

    gen = torch.Generator().manual_seed(0)
    layer = torch.nn.Linear(5, 7)
    block = torch.randn((2, 4, 5), generator=gen)
    x = block.repeat(3, 1, 1)
    with CopyBatchedLinear(3):
        y = layer(x)
        with pytest.raises(ValueError, match="copy-major"):
            layer(torch.randn((4, 5), generator=gen))
    assert torch.equal(y[2:4], y[:2]) and torch.equal(y[4:], y[:2])
    torch.testing.assert_close(y, layer(x), rtol=1e-6, atol=1e-6)


def test_run_matrix_report_keys_equal_jax(tmp_path):
    """``run_matrix`` on a JAX-written checkpoint in both packages: the
    same report keys, scenarios, severities and cell keys."""
    params = EnvParams(max_steps=5)
    ours = run_matrix([str(CKPT)], params, ["clean", "wind"], [0.0, 1.0],
                      num_formations=2, device="cpu")
    theirs = jax_run_matrix([str(CKPT)], jax_params(params),
                            ["clean", "wind"], [0.0, 1.0], num_formations=2)
    assert set(ours) == set(theirs)
    for key in ("scenarios", "severities", "checkpoints", "eval_formations",
                "num_agents", "seed", "deterministic", "eval_compiles"):
        assert ours[key] == theirs[key], key
    cells = ours["matrix"][str(CKPT)]
    ref = theirs["matrix"][str(CKPT)]
    assert {s: set(v) for s, v in cells.items()} == {
        s: set(v) for s, v in ref.items()}
    assert set(cells["wind"]["1"]) == set(ref["wind"]["1"])


def test_load_checkpoint_raw_reads_jax_files_and_quarantines_corrupt(
        tmp_path):
    ours, theirs = load_checkpoint_raw(CKPT), jax_load_checkpoint_raw(CKPT)
    flat_ours = dict(_flat(ours))
    flat_theirs = dict(_flat(theirs))
    assert list(flat_ours) == list(flat_theirs)
    for key, leaf in flat_theirs.items():
        np.testing.assert_array_equal(np.asarray(flat_ours[key]),
                                      np.asarray(leaf), err_msg=key)
    payload = CKPT.read_bytes()
    footer = struct.pack("<Iq8s", zlib.crc32(payload) & 0xFFFFFFFF,
                         len(payload), b"MARLCKPT")
    for pkg, loader in (("port", load_checkpoint_raw),
                        ("jax", jax_load_checkpoint_raw)):
        bad = tmp_path / pkg / "rl_model_7_steps.msgpack"
        bad.parent.mkdir()
        bad.write_bytes(payload[:-1] + b"\x00" + footer)
        with pytest.raises(Exception, match="checksum") as e:
            loader(bad)
        assert not bad.exists()
        assert (bad.parent / (bad.name + ".quarantined")).exists()
        if pkg == "port":
            assert isinstance(e.value, CorruptCheckpointError)
    with pytest.raises(CorruptCheckpointError):
        LoadedPolicy.from_checkpoint(
            _corrupt_copy(tmp_path / "policy", payload), device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _corrupt_copy(folder, payload):
    folder.mkdir()
    path = folder / "rl_model_9_steps.msgpack"
    footer = struct.pack("<Iq8s", 0, len(payload), b"MARLCKPT")
    path.write_bytes(payload + footer)
    return path


# ---------------------------------------------------------------------------
# The CLI (JAX tests/test_scenarios.py::test_robustness_matrix_cli_emits_json)
# ---------------------------------------------------------------------------


def _tiny_run(tmp_path, name="matrixrun"):
    params = EnvParams(num_agents=3, max_steps=5)
    trainer = Trainer(
        params, PPOConfig(n_steps=2, batch_size=8, n_epochs=1),
        TrainConfig(num_formations=4, checkpoint=True, name=name,
                    log_dir=str(tmp_path / "logs" / name)),
        model=MLPActorCritic(params.obs_dim,
                             generator=torch.Generator().manual_seed(0)),
        device="cpu",
    )
    trainer.run_iteration()
    trainer.save()
    trainer.run_iteration()
    trainer.save()


@pytest.fixture
def cli_root(tmp_path, monkeypatch):
    (tmp_path / "cfg").mkdir()
    shutil.copy(ROOT / "cfg" / "config.yaml", tmp_path / "cfg")
    monkeypatch.setattr(config, "repo_root", lambda: tmp_path)
    monkeypatch.setattr(rm, "repo_root", lambda: tmp_path)
    _tiny_run(tmp_path)
    return tmp_path


def test_robustness_matrix_cli_emits_json(cli_root, capsys):
    report = rm.main(["name=matrixrun", "num_agents_per_formation=3",
                      "max_steps=5", "eval_formations=4", "device=cpu"])
    assert len(report["scenarios"]) >= 5
    assert len(report["checkpoints"]) == 2
    assert len(report["severities"]) >= 3
    assert report["eval_compiles"] == 1
    assert report["resolved_platform"] == "cpu"
    on_disk = json.loads(Path(report["out"]).read_text())
    assert Path(report["out"]) == (cli_root / "logs" / "matrixrun"
                                   / "robustness_matrix.json")
    assert set(on_disk["matrix"]) == set(report["checkpoints"])
    cell = next(iter(next(iter(on_disk["matrix"].values())).values()))
    assert "episode_return_per_agent" in next(iter(cell.values()))
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("[matrix] 2 checkpoints x 11 scenarios x 3 "
                             "severities, M=4, compiles=1")
    assert json.loads(out[-1])["eval_compiles"] == 1
    with pytest.raises(SystemExit, match="registered scenarios"):
        rm.main(["name=matrixrun", "scenarios=[windd]", "device=cpu"])


def test_robustness_matrix_cli_keys_and_defaults_as_jax():
    import sys

    sys.path.insert(0, str(ROOT / "scripts"))
    import robustness_matrix as jax_rm

    assert set(rm.MATRIX_KEYS) - {"device"} == set(jax_rm.MATRIX_KEYS)
    with pytest.raises(SystemExit, match="did you mean 'severities'"):
        rm.main(["severitie=[1]", "device=cpu"])
    with pytest.raises(SystemExit, match="no checkpoints under"):
        rm.main(["name=no_such_run_anywhere", "device=cpu"])
