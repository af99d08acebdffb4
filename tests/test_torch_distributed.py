"""The port's data parallelism across processes on the CPU: gloo ranks
started by ``parallel.launch``, against the JAX package and the port's
single run.

One launch of two ranks runs every multi-process case in turn (a process
imports torch once), and the tests read its report:

- one dp=2 iteration with JAX's resets, noise and permutations injected
  (the rollout's whole-batch draws, each rank keeping its block), against
  JAX's ``make_shard_fn({"dp": 2})`` program: parameters within
  ``adam_parity_atol`` (rtol 0), Adam's count exact, the iteration's
  metrics within ``trajectory_rtol`` (``tests/adam_budget.py``, as
  ``test_torch_trainer.py``'s injected iteration);
- the port's dp=2 ``Trainer`` against its single run over 2 iterations:
  parameters within rtol 1e-4, atol 1e-6 (JAX's ``tests/test_parallel.py``
  tolerance, at its depth);
- the counterparts of JAX's three two-process runs
  (``tests/test_multiprocess.py``): training with coordinator-only
  checkpoints and a broadcast resume, the population sweep over the seed
  axis with a bit-exact broadcast resume, and the heterogeneous curriculum
  with its rollout cursor; both ranks' values must agree bitwise (they are
  replicated), where JAX's budget allows its SPMD lowerings to differ.

Single-process cases: the wire-up without a launcher, the backend choice,
and the sharded resets' rows against the unsharded resets.
"""

import json
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from flax.training.train_state import TrainState

from adam_budget import adam_parity_atol, trajectory_rtol
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.parallel import (
    make_shard_fn as jax_make_shard_fn,
)
from marl_distributedformation_tpu.train.trainer import (
    make_ppo_iteration as jax_make_ppo_iteration,
)
from marl_distributedformation_tpu_torch.algo import PPOConfig
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.env.formation import (
    reset_batch,
    step_batch,
)
from marl_distributedformation_tpu_torch.env.hetero import (
    hetero_reset_batch,
)
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.parallel import (
    Mesh,
    hetero_reset_batch_sharded,
    init_distributed,
    reset_batch_sharded,
)
from marl_distributedformation_tpu_torch.parallel.distributed import (
    choose_backend,
)
from marl_distributedformation_tpu_torch.parallel.launch import launch
from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer
from test_torch_algo import (
    _configs,
    _jax_permutations,
    _pair,
    jax_rollout_noise,
    t,
)
from test_torch_env import jax_params, jax_reset_uniforms, to_port
from test_torch_models import np_tree

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
RTOL, ATOL = 1e-4, 1e-6  # JAX's dp-against-single tolerance
TIMEOUT_S = 240

# The injected dp=2 iteration: ring obs, the MLP, resets inside the
# rollout (max_steps=3), 2 epochs of 3 minibatches of 32 agent rows.
INJ_PARAMS = EnvParams(num_agents=4, max_steps=3)
INJ_M, INJ_STEPS, INJ_EPOCHS, INJ_BATCH = 8, 3, 2, 32

WORKER = r'''
import json, sys
import numpy as np
import torch

sys.path.insert(0, "__REPO__")
torch.set_num_threads(1)

from marl_distributedformation_tpu_torch.algo import PPOConfig, adam_init
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.env.formation import step_batch
from marl_distributedformation_tpu_torch.env.types import FormationState
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.parallel import (
    init_distributed, is_coordinator, make_mesh, make_shard_fn,
)
from marl_distributedformation_tpu_torch.parallel.distributed import (
    process_index, world_size,
)
from marl_distributedformation_tpu_torch.train import (
    Curriculum, CurriculumStage, HeteroTrainer, SweepTrainer, TrainConfig,
    Trainer,
)
from marl_distributedformation_tpu_torch.train.curriculum import (
    padded_env_params,
)
from marl_distributedformation_tpu_torch.train.iteration import (
    DataParallelIteration,
)
from marl_distributedformation_tpu_torch.train.sweep import member_block

data_path, out = sys.argv[1], sys.argv[2]
assert init_distributed(device="cpu"), "the launcher's variables wire a group"
assert world_size() == 2
rank = process_index()
report = {"rank": rank}


def flat_params(model):
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def digest(tree):
    return float(sum(np.abs(np.asarray(v, np.float64)).sum() * (i + 1)
                     for i, (_, v) in enumerate(sorted(tree.items()))))


# 1. One dp=2 iteration with JAX's draws injected.
data = torch.load(data_path)
p = EnvParams(**data["params"])
mesh = make_mesh({"dp": 2})
model = MLPActorCritic(obs_dim=p.obs_dim)
model.load_state_dict(data["init"])
cfg = PPOConfig(**data["ppo"])
state = FormationState(**data["state"])
block = mesh.take  # rows of the rank's block (formations over 'dp')
fresh_seq = iter(data["fresh"])


def env_step(s, v):
    fresh = FormationState(**next(fresh_seq))
    fresh = FormationState(agents=block(fresh.agents),
                           goal=block(fresh.goal),
                           obstacles=block(fresh.obstacles),
                           steps=block(fresh.steps))
    return step_batch(s, v, p, fresh=fresh)


opt = adam_init(dict(model.named_parameters()))
it = DataParallelIteration(
    p, cfg, model, opt, None,
    FormationState(agents=block(state.agents), goal=block(state.goal),
                   obstacles=block(state.obstacles), steps=block(state.steps)),
    block(data["obs"]), env_step_fn=env_step, mesh=mesh)
it.run(data["noise"], data["perms"])
row = it.ring.take(1)[0]
report["injected"] = {
    "params": {k: v.tolist() for k, v in flat_params(model).items()},
    "count": int(opt.count), "step": int(it.step),
    "metrics": {n: float(row[j]) for j, n in enumerate(it.metric_names())},
}

# 2. The dp=2 Trainer: 2 iterations, a checkpoint, a broadcast resume.
def trainer(resume, log_dir):
    return Trainer(
        EnvParams(num_agents=4, max_steps=8),
        ppo=PPOConfig(n_steps=2, batch_size=64, n_epochs=1),
        config=TrainConfig(num_formations=8, checkpoint=True, save_freq=1,
                           name="mh", log_dir=log_dir, resume=resume),
        model=MLPActorCritic(obs_dim=8,
                             generator=torch.Generator().manual_seed(0)),
        device="cpu", shard_fn=make_shard_fn({"dp": 2}))


log_dir = out + "/train"
tr = trainer(False, log_dir)
for _ in range(2):
    tr.run_iteration()
report["train_params"] = {k: v.tolist()
                          for k, v in flat_params(tr.model).items()}
path = tr.save()
report["coordinator_path"] = path is not None
steps = tr.num_timesteps
resumed = trainer(True, log_dir)
report["resumed_steps"] = [resumed.num_timesteps, steps]
report["resumed_digest"] = digest(flat_params(resumed.model))
report["saved_digest"] = digest(flat_params(tr.model))
report["resumed_loss"] = float(resumed.run_iteration()["loss"])

# 3. The population sweep over the seed axis: 4 members, 2 a rank.
per_iter = 2 * 2 * 3
sweep_dir = out + "/sweep"


def sweep(resume, total):
    seeds = member_block(4, mesh)
    return SweepTrainer(
        EnvParams(num_agents=3, max_steps=8),
        ppo=PPOConfig(n_steps=2, batch_size=12, n_epochs=1),
        config=TrainConfig(num_formations=2, checkpoint=True,
                           save_freq=10**9, name="mhsweep", log_dir=sweep_dir,
                           resume=resume, total_timesteps=total),
        num_seeds=4,
        models=[MLPActorCritic(obs_dim=8,
                               generator=torch.Generator().manual_seed(i))
                for i in seeds],
        learning_rates=[1e-3, 2e-3, 3e-3, 4e-3], device="cpu", mesh=mesh)


s = sweep(False, per_iter)
report["sweep_members"] = list(s.members)
s.train()
pre = s._population_host()
res = sweep(True, 2 * per_iter)
post = res._population_host()
report["sweep_steps"] = res.num_timesteps
report["sweep_exact"] = all(
    np.array_equal(pre["params"][k], post["params"][k]) for k in pre["params"])
report["sweep_reward"] = res._host_metrics(res.run_iteration())[
    "reward"].tolist()

# 4. The heterogeneous curriculum with a broadcast resume.
curriculum = Curriculum(stages=(
    CurriculumStage(rollouts=1, agent_counts=(3,)),
    CurriculumStage(rollouts=1, agent_counts=(3, 4), num_obstacles=1),
))
hetero_dir = out + "/hetero"
env = EnvParams(num_agents=3, max_steps=8)
padded = padded_env_params(curriculum, env)


def hetero(resume):
    return HeteroTrainer(
        curriculum, env, PPOConfig(n_steps=2, batch_size=32, n_epochs=1),
        TrainConfig(num_formations=8, checkpoint=True, save_freq=1,
                    name="mh-hetero", log_dir=hetero_dir, resume=resume),
        model=MLPActorCritic(obs_dim=padded.obs_dim,
                             generator=torch.Generator().manual_seed(0)),
        device="cpu", shard_fn=make_shard_fn({"dp": 2}))


h = hetero(False)
h.train()
report["hetero_rollouts"] = h.completed_rollouts
report["hetero_block"] = list(h.env_state.agents.shape)
hr = hetero(True)
report["hetero_resumed"] = [hr.completed_rollouts, hr.num_timesteps,
                            h.num_timesteps]
hr.start_stage(curriculum.stages[-1])
report["hetero_loss"] = float(hr.run_iteration()["loss"])
report["coordinator"] = is_coordinator()
print("REPORT " + json.dumps(report), flush=True)
'''


def _jax_injected():
    """JAX's dp=2 iteration and the port's inputs for it: the initial
    state, observation, model, whole-batch noise, permutations and each
    step's fresh formations (drawn from the JAX package's per-formation
    keys, as ``test_torch_algo.injected_env_step`` tracks them)."""
    import jax.numpy as jnp

    p = INJ_PARAMS
    jp = jax_params(p)
    jmodel, jvars, model, policy = _pair("mlp")
    jcfg, cfg = _configs(n_steps=INJ_STEPS, n_epochs=INJ_EPOCHS,
                         batch_size=INJ_BATCH)
    m, n = INJ_M, p.num_agents
    jstate = jax_reset_batch(jax.random.PRNGKey(21), jp, m)
    jobs = jax_compute_obs(jstate.agents, jstate.goal, jp)
    ts = TrainState.create(apply_fn=jmodel.apply, params=jvars,
                           tx=jcfg.make_optimizer())
    key = jax.random.PRNGKey(22)
    ts_s, jstate_s, jobs_s = jax_make_shard_fn({"dp": 2})(ts, jstate, jobs)
    iteration = jax.jit(jax_make_ppo_iteration(jp, jcfg, False))
    ts2, _, _, _, jmetrics = iteration(ts_s, jstate_s, jobs_s, key)
    _, k_roll, k_update = jax.random.split(key, 3)
    rows = INJ_STEPS * m * n
    used = rows // INJ_BATCH * INJ_BATCH
    # The fresh formations of each step, from the keys the JAX step
    # carries (a formation's key moves on only at its reset).
    fresh, keys = [], jstate.key
    state = to_port(jstate)
    noise = jax_rollout_noise(k_roll, INJ_STEPS, (m, n, 2))
    for step in range(INJ_STEPS):
        f = reset_batch(p, m, uniforms=jax_reset_uniforms(keys, p))
        fresh.append(dict(agents=f.agents, goal=f.goal,
                          obstacles=f.obstacles, steps=f.steps))
        velocity = torch.zeros(m, n, 2)  # only the steps counter matters
        state, tr = step_batch(state, velocity, p, fresh=f)
        new = jax.vmap(lambda k: jax.random.split(k, 4)[0])(keys)
        keys = jnp.where(jnp.asarray(tr.done.numpy())[:, None], new, keys)
    data = {
        "params": {"num_agents": p.num_agents, "max_steps": p.max_steps},
        "ppo": {"n_steps": INJ_STEPS, "n_epochs": INJ_EPOCHS,
                "batch_size": INJ_BATCH},
        "init": model.state_dict(),
        "state": dict(to_port(jstate).__dict__), "obs": t(jobs),
        "noise": noise,
        "perms": _jax_permutations(k_update, INJ_EPOCHS, rows, used),
        "fresh": fresh,
    }
    updates = INJ_EPOCHS * (rows // INJ_BATCH)
    return data, ts2, jmetrics, policy, updates


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank launch's reports, with JAX's injected iteration and
    the port's single runs beside them."""
    tmp = tmp_path_factory.mktemp("dist")
    data, ts2, jmetrics, policy, updates = _jax_injected()
    torch.save(data, tmp / "data.pt")
    worker = tmp / "worker.py"
    worker.write_text(WORKER.replace("__REPO__", str(REPO)))
    results = launch([str(worker), str(tmp / "data.pt"), str(tmp / "out")],
                     nprocs=2, timeout=TIMEOUT_S, cwd=str(REPO),
                     env={**os.environ, "OMP_NUM_THREADS": "1"})
    reports = []
    for rank, (code, out) in enumerate(results):
        lines = [ln for ln in out.splitlines() if ln.startswith("REPORT ")]
        assert code == 0 and lines, f"rank {rank} failed ({code}):\n{out}"
        reports.append(json.loads(lines[-1][len("REPORT "):]))
    return {"reports": reports, "out": tmp / "out", "jax": ts2,
            "jmetrics": jmetrics, "policy": policy, "updates": updates}


def test_dp2_iteration_matches_jax_dp2_program(two_ranks):
    """One dp=2 iteration with JAX's draws injected against JAX's
    ``make_shard_fn({"dp": 2})`` iteration: parameters within the Adam
    budget (rtol 0), Adam's count exact, metrics within the trajectory
    budget; both ranks alike bitwise."""
    r0, r1 = (r["injected"] for r in two_ranks["reports"])
    assert r0 == r1
    updates = two_ranks["updates"]
    ts = two_ranks["jax"]
    got = params_to_jax({k: torch.tensor(v) for k, v in r0["params"].items()},
                        two_ranks["policy"])
    atol = adam_parity_atol(LR, updates)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(np_tree(ts.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    jopt = serialization.to_state_dict(ts.opt_state)["1"]["0"]
    assert r0["count"] == int(jopt["count"]) == r0["step"] == updates
    jm = two_ranks["jmetrics"]
    rollout = {"reward", "episode_dones", "avg_dist_to_goal",
               "ave_dist_to_neighbor", "std_dist_to_neighbor",
               "close_to_goal_reward", "reward_dist", "reward_right_neighbor",
               "reward_left_neighbor"}
    assert set(r0["metrics"]) == set(jm)
    for k in jm:
        rtol = 1e-4 if k in rollout else trajectory_rtol(LR, updates)
        np.testing.assert_allclose(r0["metrics"][k], float(jm[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


def test_dp2_trainer_matches_single_run(two_ranks):
    """The port's dp=2 run is its single run's program: parameters after
    2 iterations within rtol 1e-4, atol 1e-6."""
    single = Trainer(
        EnvParams(num_agents=4, max_steps=8),
        ppo=PPOConfig(n_steps=2, batch_size=64, n_epochs=1),
        config=TrainConfig(num_formations=8, checkpoint=False,
                           log_dir=str(two_ranks["out"] / "single")),
        model=MLPActorCritic(obs_dim=8,
                             generator=torch.Generator().manual_seed(0)),
        device="cpu")
    for _ in range(2):
        single.run_iteration()
    for report in two_ranks["reports"]:
        for k, p in single.model.named_parameters():
            np.testing.assert_allclose(
                np.asarray(report["train_params"][k], np.float32),
                p.detach().numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def test_two_process_training_and_broadcast_resume(two_ranks):
    """Coordinator-only checkpoints and a broadcast resume: the
    coordinator alone returns the path, every rank resumes the saved
    learner at the saved step, and the next iteration's loss agrees
    across ranks bitwise."""
    r0, r1 = two_ranks["reports"]
    assert r0["coordinator_path"] and not r1["coordinator_path"]
    for r in (r0, r1):
        assert r["resumed_steps"][0] == r["resumed_steps"][1] == (
            2 * 2 * 8 * 4)
        assert r["resumed_digest"] == r["saved_digest"]
    assert r0["resumed_loss"] == r1["resumed_loss"]
    files = sorted((two_ranks["out"] / "train").glob(
        "rl_model_*_steps.msgpack"))
    assert files, "the coordinator wrote no checkpoints"


def test_two_process_population_sweep(two_ranks):
    """The seed axis over dp: each rank trains its member block, the
    coordinator writes every member's file, the anchor and the summary,
    and the broadcast resume is bit-exact."""
    r0, r1 = two_ranks["reports"]
    assert r0["sweep_members"] == [0, 1] and r1["sweep_members"] == [2, 3]
    for r in (r0, r1):
        assert r["sweep_steps"] == 12 and r["sweep_exact"]
    assert r0["sweep_reward"] == r1["sweep_reward"]
    assert len(r0["sweep_reward"]) == 4
    out = two_ranks["out"] / "sweep"
    for i in range(4):
        assert list((out / f"seed{i}").glob("rl_model_*_steps.msgpack"))
    assert list(out.glob("sweep_state_*_steps.msgpack"))
    summary = json.loads((out / "sweep_summary.json").read_text())
    assert summary["seeds"] == [0, 1, 2, 3]
    assert summary["learning_rates"] == pytest.approx(
        [1e-3, 2e-3, 3e-3, 4e-3])


def test_two_process_hetero_curriculum(two_ranks):
    """Both stages under dp=2 (each rank its 4 formations of the sharded
    hetero reset), coordinator-only checkpoints, the broadcast resume of
    the rollout cursor, and a loss alike on both ranks."""
    r0, r1 = two_ranks["reports"]
    for r in (r0, r1):
        assert r["hetero_rollouts"] == 2
        assert r["hetero_block"] == [4, 4, 2]
        assert r["hetero_resumed"][0] == 2
        assert r["hetero_resumed"][1] == r["hetero_resumed"][2]
    assert r0["hetero_loss"] == r1["hetero_loss"]
    assert np.isfinite(r0["hetero_loss"])
    assert list((two_ranks["out"] / "hetero").glob(
        "rl_model_*_steps.msgpack"))


# ---------------------------------------------------------------------------
# Single process
# ---------------------------------------------------------------------------


def test_init_distributed_alone_is_a_world_of_one(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed(device="cpu") is False
    assert init_distributed(device="cpu") is False  # idempotent


@pytest.mark.parametrize("device,local_world,count,want", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 1, "gloo"),  # two ranks share one card
])
def test_backend_follows_the_device_map(device, local_world, count, want):
    assert choose_backend(torch.device(device), local_world, count) == want


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_resets_equal_unsharded_rows(dp):
    """Each rank's rows of ``reset_batch_sharded`` and
    ``hetero_reset_batch_sharded`` equal the unsharded resets' bitwise
    (the whole batch's draws, the block kept)."""
    p = EnvParams(num_agents=5, num_obstacles=2)
    m = 8
    whole = reset_batch(p, m, torch.Generator().manual_seed(3), "cpu")
    n_agents = torch.tensor([2, 5, 3, 4, 5, 2, 3, 4], dtype=torch.int32)
    n_obstacles = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], dtype=torch.int32)
    hwhole = hetero_reset_batch(p, n_agents, n_obstacles,
                                torch.Generator().manual_seed(4), "cpu")
    for rank in range(dp):
        mesh = Mesh(("dp",), (dp,), rank=rank)
        block = reset_batch_sharded(torch.Generator().manual_seed(3), p, m,
                                    mesh, "cpu")
        lo, hi = block.start, block.start + block.count
        assert (lo, block.count, block.total) == (rank * m // dp, m // dp, m)
        for f in ("agents", "goal", "obstacles", "steps"):
            assert torch.equal(getattr(block.tree, f),
                               getattr(whole, f)[lo:hi]), f
        hblock = hetero_reset_batch_sharded(
            torch.Generator().manual_seed(4), p, n_agents, n_obstacles, mesh,
            "cpu").tree
        for f in ("agents", "goal", "obstacles", "steps", "n_agents",
                  "n_obstacles"):
            assert torch.equal(getattr(hblock, f),
                               getattr(hwhole, f)[lo:hi]), f


def test_launcher_reports_each_rank_and_its_failure(tmp_path):
    """Each rank's code and output in rank order; a failed rank takes the
    others down at once (rank 0 would sleep for a minute)."""
    script = tmp_path / "r.py"
    script.write_text("import os, sys, time\nprint('rank', os.environ['RANK'], "
                      "os.environ['WORLD_SIZE'], flush=True)\n"
                      "if sys.argv[1:] == ['fail']:\n"
                      "    time.sleep(60) if os.environ['RANK'] == '0' "
                      "else sys.exit(3)\n")
    assert launch([str(script)], nprocs=2, timeout=60) == [
        (0, "rank 0 2\n"), (0, "rank 1 2\n")]
    t0 = time.perf_counter()
    (code0, _), (code1, out1) = launch([str(script), "fail"], nprocs=2,
                                       timeout=60)
    assert code1 == 3 and out1 == "rank 1 2\n"
    assert code0 != 0 and time.perf_counter() - t0 < 30
