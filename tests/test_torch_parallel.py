"""The port's ``parallel/`` against the JAX package's on the CPU: mesh
shapes and errors, the shard hook's refusals, the agent-axis ring step of
gloo ranks against JAX's ``make_ring_step`` on conftest's CPU devices, and
the ``train`` CLI's ``mesh`` and its refusals.

The ring step runs at (dp, sp) of (1, 2) and (2, 2), for ring and k-NN
observations, one launch a world size (every case of that size in turn).
JAX's trajectory comes first, its per-formation keys' fresh formations
recorded each step and injected into the port's step (``fresh=``); each
rank then holds its slab against JAX's: observations within rtol 1e-5
atol 1e-6, ``done`` bitwise, rewards and metrics within rtol 1e-4 atol
1e-4, positions within 1e-5 (``tests/test_parallel.py:99-135``).
"""

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.env import EnvParams as JaxEnvParams
from marl_distributedformation_tpu.env.formation import (
    reset as jax_reset,
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.parallel import (
    make_mesh as jax_make_mesh,
    make_ring_step as jax_make_ring_step,
    make_shard_fn as jax_make_shard_fn,
    place_ring_state as jax_place_ring_state,
)
from marl_distributedformation_tpu.parallel.mesh import (
    resolve_axis_sizes as jax_resolve_axis_sizes,
)
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.env.formation import reset_batch
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    ProgramLedger,
    set_ledger,
    set_registry,
)
from marl_distributedformation_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    make_ring_step,
    make_shard_fn,
    resolve_axis_sizes,
)
from marl_distributedformation_tpu_torch.parallel.launch import launch
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from marl_distributedformation_tpu_torch.train import cli as train_cli
from marl_distributedformation_tpu_torch.train import trainer as trainer_mod
from test_torch_env import to_port

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
STEPS = 8  # through the strict-parity auto-reset at max_steps=3

# (obs_mode, dp, sp): N=8 agents, M=4 formations a dp rank.
RING_CASES = [(obs, dp, sp) for dp, sp in ((1, 2), (2, 2))
              for obs in ("ring", "knn")]


# ---------------------------------------------------------------------------
# Mesh shapes and errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,n", [
    ({"dp": 8}, 8), ({"dp": 4, "sp": 2}, 8), ({"dp": -1}, 8),
    ({"dp": -1, "sp": 2}, 8), ({"dp": 2, "sp": -1}, 8), ({"dp": 1}, 1),
])
def test_resolve_axis_sizes_as_jax(spec, n):
    assert resolve_axis_sizes(spec, n) == jax_resolve_axis_sizes(spec, n)


def test_resolve_axis_sizes_refuses_as_jax():
    with pytest.raises(ValueError) as jax_err:
        jax_resolve_axis_sizes({"dp": 16}, 8)
    with pytest.raises(ValueError) as err:
        resolve_axis_sizes({"dp": 16}, 8)
    assert str(err.value) == str(jax_err.value)


def test_make_mesh_in_one_process():
    """A process alone is a world of one rank (``tests/test_parallel.py:18``
    on 8 devices): ``{dp: 1}`` and ``{dp: -1}`` cover it, more ranks than
    the world is JAX's error."""
    assert make_mesh({"dp": 1}).shape == {"dp": 1}
    assert make_mesh({"dp": -1}).shape == {"dp": 1}
    assert make_mesh({"dp": 1, "sp": 1}).shape == {"dp": 1, "sp": 1}
    with pytest.raises(ValueError, match="needs 2 devices; only 1"):
        make_mesh({"dp": 2})


def test_mesh_coordinates_are_row_major():
    for rank, coords in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        mesh = Mesh(("dp", "sp"), (2, 2), rank=rank)
        assert (mesh.index("dp"), mesh.index("sp")) == coords
        assert mesh.whole_shape((3, 4, 2)) == (6, 8, 2)
        rows = torch.arange(6 * 8).reshape(6, 8)
        block = mesh.take(rows)
        assert torch.equal(block, rows[3 * coords[0]:3 * coords[0] + 3,
                                       4 * coords[1]:4 * coords[1] + 4])


def test_shard_fn_refuses_as_jax():
    """Unknown axes and an M the dp axis does not divide
    (``tests/test_parallel.py:84-96``)."""
    with pytest.raises(ValueError, match="unknown axes"):
        make_shard_fn(mesh=Mesh(("dp", "tp"), (1, 1)))
    shard_fn = make_shard_fn(mesh=Mesh(("dp",), (2,)))
    p = EnvParams(num_agents=3)
    state = reset_batch(p, 3, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_fn({}, state, torch.zeros(3, 3, p.obs_dim))


def test_ring_step_refusals_as_jax():
    jax_mesh = jax_make_mesh({"dp": 2, "sp": 4})
    for params in (EnvParams(num_agents=6),):
        with pytest.raises(ValueError) as jax_err:
            jax_make_ring_step(JaxEnvParams(num_agents=6), jax_mesh)
        with pytest.raises(ValueError) as err:
            make_ring_step(params, Mesh(("dp", "sp"), (2, 4)))
        assert str(err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# The ring step across gloo ranks against JAX's
# ---------------------------------------------------------------------------

RING_WORKER = r'''
import json, sys
import torch

sys.path.insert(0, "__REPO__")
torch.set_num_threads(1)

from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.env.types import FormationState
from marl_distributedformation_tpu_torch.parallel import (
    init_distributed, make_mesh, make_ring_step, place_ring_state,
)
from marl_distributedformation_tpu_torch.parallel.distributed import (
    process_index, world_size,
)

data = torch.load(sys.argv[1])
init_distributed(device="cpu")
tol = {"obs": (1e-5, 1e-6), "reward": (1e-4, 1e-4),
       "metrics": (1e-4, 1e-4), "agents": (1e-5, 1e-5)}
report = {}
for case in data:
    obs_mode, dp, sp = case["case"]
    if dp * sp != world_size():
        continue
    mesh = make_mesh({"dp": dp, "sp": sp})
    params = EnvParams(num_agents=8, max_steps=3, obs_mode=obs_mode,
                       knn_k=3)
    step = make_ring_step(params, mesh)
    state = place_ring_state(FormationState(**case["state"]), mesh)
    rows = lambda t: mesh.take(t) if t.dim() > 1 else t.narrow(
        0, mesh.index("dp") * (t.shape[0] // dp), t.shape[0] // dp)
    ok, err, done_equal = {}, {}, True

    def note(key, got, want):
        rtol, atol = tol[key]
        err[key] = max(err.get(key, 0.0), float((got - want).abs().max()))
        ok[key] = ok.get(key, True) and bool(
            torch.allclose(got, want, rtol=rtol, atol=atol))

    for t in range(len(case["velocity"])):
        fresh = place_ring_state(FormationState(**case["fresh"][t]), mesh)
        state, tr = step(state, mesh.take(case["velocity"][t]), fresh=fresh)
        want = case["out"][t]
        note("obs", tr.obs, mesh.take(want["obs"]))
        note("reward", tr.reward, mesh.take(want["reward"]))
        note("agents", state.agents, mesh.take(want["agents"]))
        for k, v in want["metrics"].items():
            note("metrics", tr.metrics[k], rows(v))
        done_equal = done_equal and bool(torch.equal(tr.done,
                                                     rows(want["done"])))
    report["/".join(map(str, case["case"]))] = {
        "ok": ok, "err": err, "done": done_equal}
print("REPORT " + json.dumps({"rank": process_index(), "cases": report}),
      flush=True)
'''


def _jax_ring_case(obs_mode, dp, sp):
    """JAX's ring step on a (dp, sp) mesh of conftest's CPU devices, 8
    steps: the initial state, velocities, each step's fresh formations
    (from the carried keys, as the step draws them) and its outputs."""
    jp = JaxEnvParams(num_agents=8, max_steps=3, obs_mode=obs_mode, knn_k=3,
                      knn_impl="xla")
    m = 4 * dp
    mesh = jax_make_mesh({"dp": dp, "sp": sp})
    ring_step = jax_make_ring_step(jp, mesh)
    state0 = jax_reset_batch(jax.random.PRNGKey(7), jp, m)
    state = jax_place_ring_state(state0, mesh)
    rng = np.random.default_rng(11)
    fresh_all = jax.jit(jax.vmap(jax_reset, in_axes=(0, None)),
                        static_argnums=1)
    case = {"case": (obs_mode, dp, sp), "state": to_port(state0).__dict__,
            "velocity": [], "fresh": [], "out": []}
    for _ in range(STEPS):
        vel = rng.uniform(-10, 10, (m, 8, 2)).astype(np.float32)
        case["fresh"].append(to_port(fresh_all(state.key, jp)).__dict__)
        state, tr = ring_step(state, jax.numpy.asarray(vel))
        case["velocity"].append(torch.from_numpy(vel))
        case["out"].append({
            "obs": torch.from_numpy(np.array(tr.obs)),
            "reward": torch.from_numpy(np.array(tr.reward)),
            "done": torch.from_numpy(np.array(tr.done)),
            "agents": torch.from_numpy(np.array(state.agents)),
            "metrics": {k: torch.from_numpy(np.array(v))
                        for k, v in tr.metrics.items()},
        })
    return case


@pytest.fixture(scope="module")
def ring_reports(tmp_path_factory):
    """Every rank's report of every ring case of a world size: one launch
    a world size, at its first case, so a failed launch fails that size's
    cases only."""
    tmp = tmp_path_factory.mktemp("ring")
    torch.save([_jax_ring_case(*c) for c in RING_CASES], tmp / "data.pt")
    worker = tmp / "worker.py"
    worker.write_text(RING_WORKER.replace("__REPO__", str(REPO)))
    launched = {}

    def reports(world):
        if world not in launched:
            results = launch([str(worker), str(tmp / "data.pt")],
                             nprocs=world, timeout=TIMEOUT_S, cwd=str(REPO),
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
            launched[world] = [
                (rank, code, out,
                 [ln for ln in out.splitlines() if ln.startswith("REPORT ")])
                for rank, (code, out) in enumerate(results)]
        out = []
        for rank, code, text, lines in launched[world]:
            assert code == 0 and lines, f"rank {rank} failed:\n{text}"
            out.append(json.loads(lines[-1][len("REPORT "):]))
        return out

    return reports


@pytest.mark.parametrize("obs_mode,dp,sp", RING_CASES)
def test_ring_step_matches_jax(ring_reports, obs_mode, dp, sp):
    key = f"{obs_mode}/{dp}/{sp}"
    for report in ring_reports(dp * sp):
        got = report["cases"][key]
        assert got["done"], (report["rank"], got)
        assert all(got["ok"].values()), (report["rank"], got)


TAKEN_PORT_WORKER = r'''
import json, os, sys
import torch

sys.path.insert(0, "__REPO__")
from marl_distributedformation_tpu_torch.parallel import init_distributed
from marl_distributedformation_tpu_torch.parallel.distributed import (
    all_reduce_sum, process_index,
)

init_distributed(device="cpu")
total = all_reduce_sum(torch.ones(1) * (process_index() + 1))
print("REPORT " + json.dumps({"rank": process_index(),
                              "port": int(os.environ["MASTER_PORT"]),
                              "sum": float(total)}), flush=True)
'''


def test_launch_survives_a_port_taken_before_the_ranks_start(
        tmp_path, monkeypatch):
    """The port the launcher picks is bound by another process before any
    rank starts (the race of picking a free port and binding it later):
    the launcher's store moves to a fresh port and the world forms."""
    import socket

    from marl_distributedformation_tpu_torch.parallel import (
        launch as launch_mod,
    )

    taken = socket.socket()
    taken.bind(("localhost", 0))
    taken.listen()
    port = taken.getsockname()[1]
    picks = iter([port])
    real = launch_mod.free_port
    monkeypatch.setattr(launch_mod, "free_port",
                        lambda: next(picks, None) or real())
    worker = tmp_path / "worker.py"
    worker.write_text(TAKEN_PORT_WORKER.replace("__REPO__", str(REPO)))
    try:
        results = launch([str(worker)], nprocs=2, timeout=TIMEOUT_S,
                         cwd=str(REPO),
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    finally:
        taken.close()
    reports = []
    for rank, (code, out) in enumerate(results):
        lines = [ln for ln in out.splitlines() if ln.startswith("REPORT ")]
        assert code == 0 and lines, f"rank {rank} failed:\n{out}"
        reports.append(json.loads(lines[-1][len("REPORT "):]))
    assert [r["rank"] for r in reports] == [0, 1]
    assert {r["port"] for r in reports} != {port}
    assert len({r["port"] for r in reports}) == 1
    assert [r["sum"] for r in reports] == [3.0, 3.0]


# ---------------------------------------------------------------------------
# The train CLI's mesh and its refusals
# ---------------------------------------------------------------------------


@pytest.fixture
def private_registry():
    """A fresh process-global registry and ledger, restored afterwards."""
    prev = set_registry(MetricsRegistry()), set_ledger(ProgramLedger())
    try:
        yield
    finally:
        set_registry(prev[0])
        set_ledger(prev[1])


def test_train_cli_accepts_mesh(tmp_path, monkeypatch, private_registry):
    """``mesh={dp: 1}`` trains on the CPU when asked for (the one-rank
    NCCL group's path on the card), and runs the single run's program."""
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    argv = ["num_formation=4", "num_agents_per_formation=3", "n_steps=2",
            "batch_size=12", "n_epochs=1", "total_timesteps=24",
            "device=cpu"]
    meshed = train_cli.build_trainer(["name=m", "mesh={dp: 1}", *argv])
    single = train_cli.build_trainer(["name=s", *argv])
    meshed.train()
    single.train()
    assert meshed.mesh.shape == {"dp": 1}
    assert meshed.num_timesteps == single.num_timesteps == 24
    for (k, a), (_, b) in zip(meshed.model.named_parameters(),
                              single.model.named_parameters()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="needs 2 devices; only 1"):
        train_cli.build_trainer(["name=x", "mesh={dp: 2}", *argv])


# The JAX package's words for what does not compose with a mesh (its
# train.py, train/trainer.py and sebulba/driver.py).
MESH_REFUSALS = {
    "sebulba": ("sebulba partitions WHOLE devices into actor/learner "
                "slices; mesh sharding (shard_fn) is Anakin-only"),
    "scenarios_knn": ("scenario training does not compose with the "
                      "shard_map knn env step a dp mesh uses for "
                      "obs_mode=knn"),
    "scenarios_sp": ("scenario training does not compose with the "
                     "agent-axis ('sp') sharded ring step"),
    "scenarios_multihost": "scenario training is single-host for now",
    "env": "does not compose with mesh sharding / multi-host yet",
    # A mesh that names 'sp' at size 1 is an 'sp' mesh to the JAX package
    # (its Trainer steps it through make_ring_step, its curriculum refuses
    # it): both refused in its types and words, held against it below.
    "scenarios_sp1": ("scenario training does not compose with the "
                      "agent-axis ('sp') sharded ring step"),
    "curriculum_sp1": ("curriculum/hetero training does not support "
                       "agent-axis ('sp') sharding"),
}


@pytest.mark.parametrize("case", sorted(MESH_REFUSALS))
def test_mesh_refusals_in_jax_words(case, tmp_path, monkeypatch,
                                    private_registry):
    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    want = MESH_REFUSALS[case]
    base = ["num_formation=4", "num_agents_per_formation=4", "device=cpu",
            "mesh={dp: 1}"]
    if case.endswith("_sp1"):
        port_err, jax_err = _sp1_refusals(case, tmp_path)
        assert type(port_err) is type(jax_err)
        assert str(port_err) == str(jax_err)
        assert want in str(port_err)
        return
    if case == "sebulba":
        argv = [*base, "architecture=sebulba"]
    elif case == "scenarios_knn":
        argv = [*base, "obs_mode=knn", "knn_k=2", "scenarios=[wind]"]
    elif case == "env":
        argv = [*base, "env=pursuit_evasion"]
    else:
        p = EnvParams(num_agents=4)
        mesh = (Mesh(("dp", "sp"), (1, 2)) if case == "scenarios_sp"
                else Mesh(("dp",), (1,)))
        if case == "scenarios_multihost":
            monkeypatch.setattr(trainer_mod, "world_size", lambda: 2)
        from marl_distributedformation_tpu_torch.utils.config import (
            scenario_schedule_from_config,
        )
        from marl_distributedformation_tpu_torch.utils.config import (
            load_config,
        )

        schedule = scenario_schedule_from_config(
            load_config(["scenarios=[wind]"]))
        shard_fn = make_shard_fn(mesh=mesh)
        with pytest.raises(SystemExit, match=want.replace("(", r"\(")
                           .replace(")", r"\)")):
            Trainer(p, config=TrainConfig(num_formations=4, checkpoint=False,
                                          log_dir=str(tmp_path)),
                    model=MLPActorCritic(p.obs_dim), device="cpu",
                    scenario_schedule=schedule, shard_fn=shard_fn)
        return
    with pytest.raises(SystemExit, match=want.replace("(", r"\(")
                       .replace(")", r"\)")):
        train_cli.build_trainer(argv)


def _sp1_refusals(case, tmp_path):
    """What the port and the JAX package raise for ``case`` on a
    ``{dp: 1, sp: 1}`` mesh: scenarios in the Trainer, or the curriculum
    (its HeteroTrainer)."""
    from marl_distributedformation_tpu.scenarios import schedule_from_cfg
    from marl_distributedformation_tpu.train import TrainConfig as JaxTC
    from marl_distributedformation_tpu.train import Trainer as JaxTrainer
    from marl_distributedformation_tpu.train.curriculum import (
        Curriculum as JaxCurriculum,
        HeteroTrainer as JaxHeteroTrainer,
    )
    from marl_distributedformation_tpu_torch.train.curriculum import (
        Curriculum,
        HeteroTrainer,
    )
    from marl_distributedformation_tpu_torch.utils.config import (
        load_config,
        scenario_schedule_from_config,
    )

    p = EnvParams(num_agents=4)
    shard_fn = make_shard_fn(mesh=Mesh(("dp", "sp"), (1, 1)))
    jax_shard_fn = jax_make_shard_fn({"dp": 1, "sp": 1})
    config = TrainConfig(num_formations=4, checkpoint=False,
                         log_dir=str(tmp_path))
    if case == "scenarios_sp1":
        schedule = scenario_schedule_from_config(
            load_config(["scenarios=[wind]"]))
        with pytest.raises(SystemExit) as port_err:
            Trainer(p, config=config, model=MLPActorCritic(p.obs_dim),
                    device="cpu", scenario_schedule=schedule,
                    shard_fn=shard_fn)
        with pytest.raises(SystemExit) as jax_err:
            JaxTrainer(JaxEnvParams(num_agents=4),
                       config=JaxTC(num_formations=4, checkpoint=False),
                       shard_fn=jax_shard_fn,
                       scenario_schedule=schedule_from_cfg(["wind"]))
    else:
        with pytest.raises(ValueError) as port_err:
            HeteroTrainer(Curriculum(), p, config=config,
                          model=MLPActorCritic(p.obs_dim), device="cpu",
                          shard_fn=shard_fn)
        with pytest.raises(ValueError) as jax_err:
            JaxHeteroTrainer(JaxCurriculum(), JaxEnvParams(num_agents=4),
                             config=JaxTC(num_formations=4,
                                          checkpoint=False),
                             shard_fn=jax_shard_fn)
    return port_err.value, jax_err.value


def test_sp1_mesh_steps_through_the_ring_step_as_jax():
    """A ``{dp: 1, sp: 1}`` mesh steps through ``make_ring_step`` in the
    port's Trainer, as in the JAX package's. Over 8 steps through the
    auto-resets, with JAX's fresh formations injected, that step's
    positions and ``done`` equal JAX's ring step's bitwise; its
    observations and rewards equal the port's unsharded step's bitwise and
    JAX's within ``tests/test_parallel.py``'s tolerances (the two packages'
    float32 sums round apart by an ulp or two)."""
    from marl_distributedformation_tpu_torch.env.formation import step_batch
    from marl_distributedformation_tpu_torch.env.types import FormationState
    from marl_distributedformation_tpu_torch.parallel import place_ring_state

    mesh = Mesh(("dp", "sp"), (1, 1))
    tol = {"obs": (1e-5, 1e-6), "reward": (1e-4, 1e-4)}
    for obs_mode in ("ring", "knn"):
        case = _jax_ring_case(obs_mode, 1, 1)
        params = EnvParams(num_agents=8, max_steps=3, obs_mode=obs_mode,
                           knn_k=3)
        step = make_ring_step(params, mesh)
        state = place_ring_state(FormationState(**case["state"]), mesh)
        plain = FormationState(**case["state"])
        for t, want in enumerate(case["out"]):
            fresh = FormationState(**case["fresh"][t])
            state, tr = step(state, case["velocity"][t], fresh=fresh)
            plain, plain_tr = step_batch(plain, case["velocity"][t], params,
                                         fresh=fresh)
            where = (obs_mode, t)
            assert torch.equal(state.agents, want["agents"]), where
            assert torch.equal(tr.done, want["done"]), where
            assert torch.equal(state.agents, plain.agents), where
            for name, got, unsharded, ref in (
                    ("obs", tr.obs, plain_tr.obs, want["obs"]),
                    ("reward", tr.reward, plain_tr.reward, want["reward"])):
                assert torch.equal(got, unsharded), (where, name)
                rtol, atol = tol[name]
                torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
    # The Trainer takes the ring step for that mesh, the dp step for a
    # dp-only one.
    from marl_distributedformation_tpu_torch.parallel import mesh as mesh_mod
    from marl_distributedformation_tpu_torch.parallel import ring as ring_mod

    made = []
    p = EnvParams(num_agents=4)
    for shape, names in (((1, 1), ("dp", "sp")), ((1,), ("dp",))):
        with pytest.MonkeyPatch.context() as mp:
            for mod, fn in ((ring_mod, "make_ring_step"),
                            (mesh_mod, "make_dp_step")):
                real = getattr(mod, fn)
                mp.setattr(mod, fn, lambda *a, _r=real, _n=fn: (
                    made.append(_n), _r(*a))[1])
            Trainer(p, config=TrainConfig(num_formations=4,
                                          checkpoint=False),
                    model=MLPActorCritic(p.obs_dim), device="cpu",
                    shard_fn=make_shard_fn(mesh=Mesh(names, shape)))
    assert made == ["make_ring_step", "make_dp_step"]


def test_jax_refuses_in_the_same_words():
    """The words above are the JAX package's own: its Trainer refuses
    scenarios with k-NN on a dp mesh so."""
    from marl_distributedformation_tpu.scenarios import schedule_from_cfg
    from marl_distributedformation_tpu.train import TrainConfig as JaxTC
    from marl_distributedformation_tpu.train import Trainer as JaxTrainer

    with pytest.raises(SystemExit) as err:
        JaxTrainer(JaxEnvParams(num_agents=4, obs_mode="knn", knn_k=2),
                   config=JaxTC(num_formations=4, checkpoint=False),
                   shard_fn=jax_make_shard_fn({"dp": 2}),
                   scenario_schedule=schedule_from_cfg(["wind"]))
    assert MESH_REFUSALS["scenarios_knn"] in str(err.value)
