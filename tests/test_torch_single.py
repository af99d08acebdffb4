"""The port's single-formation API against the JAX package: the unbatched
k-NN (``ops/knn.py``), one formation's ``reset``/``step`` and observation,
the padded ``hetero_reset``/``hetero_step``, ``pursuit_step``,
``scenario_step``, and ``EnvSpec``'s ``reset_env``/``step_env``.

Resets are injected from the JAX package's draws of each formation's key
(``test_torch_env.jax_reset_uniforms``), the scenario layers' draws through
``test_torch_scenarios.JaxStreams`` on a batch of one. Tolerances as in
``test_torch_env.py``: integers, masks, ``done``, steps, positions and the
k-NN indices and offsets bitwise; other floats ``rtol=1e-6`` plus
``atol=1e-6`` (pursuit rewards: 1e-6 of the largest term). Within the port,
one formation's step equals its row of ``step_batch`` bitwise, and the
unmasked ``knn`` equals ``knn_local`` over every row and the rows of
``knn_batch_torch`` bitwise (the JAX package's invariant,
``ops/knn.py:76-80``).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu import envs as jenvs
from marl_distributedformation_tpu import scenarios as jsc
from marl_distributedformation_tpu.env import formation as jf
from marl_distributedformation_tpu.env import hetero as jh
from marl_distributedformation_tpu.envs import pursuit as jpursuit
import marl_distributedformation_tpu_torch as mdf
from marl_distributedformation_tpu_torch import envs, scenarios as sc
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    FormationState,
    batch_of_one,
    formation_row,
    hetero_reset,
    hetero_reset_batch,
    hetero_step,
    hetero_step_batch,
    reset,
    reset_batch,
    step,
    step_batch,
)
from marl_distributedformation_tpu_torch.env import formation as pf
from marl_distributedformation_tpu_torch.envs.pursuit import (
    PursuitParams,
    pursuit_step,
    pursuit_step_batch,
)
from marl_distributedformation_tpu_torch.ops import (
    knn,
    knn_batch_torch,
    knn_local,
    pairwise_sq_dists,
)
from test_torch_env import close, jax_params, jax_reset_uniforms, same
from test_torch_pursuit import jax_pursuit, reward_atol
from test_torch_scenarios import JaxStreams

# The module, which its package's ``knn`` function shadows as an attribute.
jknn = importlib.import_module("marl_distributedformation_tpu.ops.knn")


def t(x):
    return torch.from_numpy(np.array(x))


def jax_uniforms(key, params):
    """One formation's reset draws from its JAX key."""
    return tuple(u[0] for u in jax_reset_uniforms(key[None], params))


def to_port_one(jstate, cls=FormationState, extra=()):
    return cls(**{f: t(getattr(jstate, f))
                  for f in ("agents", "goal", "obstacles", "steps", *extra)})


# ---------------------------------------------------------------------------
# The unbatched k-NN
# ---------------------------------------------------------------------------


def _points(kind, n=24, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.uniform(0, 1, (n, 2)) * [400, 600]).astype(np.float32)
    side = 5
    g = np.arange(n)
    lattice = np.stack([(g % side) * 10.0, (g // side) * 10.0], -1)
    if kind == "duplicates":
        lattice[n // 2:] = lattice[: n - n // 2]
    return lattice.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "lattice", "duplicates"])
def test_knn_functions_match_jax_and_the_invariant(kind):
    pts = _points(kind)
    k, n = 4, pts.shape[0]
    close(pairwise_sq_dists(t(pts)), jknn.pairwise_sq_dists(pts), "d2")
    got = knn(t(pts), k)
    ref = jknn.knn(jnp.asarray(pts), k)
    same(got[0], ref[0], "idx")
    same(got[1], ref[1], "offsets")
    close(got[2], ref[2], "dists")
    # knn_local over blocks of rows, global self-masking, both packages.
    for lo, hi in ((0, 7), (7, 16), (16, n)):
        loc = knn_local(t(pts[lo:hi]), t(pts), k, lo)
        jloc = jknn.knn_local(jnp.asarray(pts[lo:hi]), jnp.asarray(pts), k, lo)
        same(loc[0], jloc[0], f"local idx {lo}")
        same(loc[1], jloc[1], f"local offsets {lo}")
        for a, b in zip(loc, got):
            assert torch.equal(a, b[lo:hi]), (lo, hi)
    # ... and the rows of the batched plain version.
    for a, b in zip(got, knn_batch_torch(t(pts)[None], k)):
        assert torch.equal(a, b[0])
    batched_local = knn_local(t(pts)[None, 5:9], t(pts)[None], k, 5)
    for a, b in zip(batched_local, got):
        assert torch.equal(a[0], b[5:9])


def test_masked_knn_short_rows_match_jax():
    pts = _points("random", n=12, seed=3)
    valid = np.zeros(12, bool)
    valid[[1, 4, 9]] = True  # three valid: every row is short of k=4
    got = knn(t(pts), 4, t(valid))
    ref = jknn.knn(jnp.asarray(pts), 4, jnp.asarray(valid))
    same(got[0], ref[0], "idx")
    same(got[1], ref[1], "offsets")
    close(got[2], ref[2], "dists")
    assert (got[0][:, -1] == torch.arange(12, dtype=torch.int32)).all()
    for a, b in zip(got, knn_batch_torch(t(pts)[None], 4, t(valid)[None])):
        assert torch.equal(a, b[0])
    with pytest.raises(ValueError, match="k < N"):
        knn(t(pts), 12)


@pytest.mark.parametrize("obs_mode", ["ring", "knn"])
def test_one_formation_obs_and_the_sharded_rows_match_jax(obs_mode):
    params = EnvParams(num_agents=16, obs_mode=obs_mode, knn_k=3)
    jp = jax_params(params)
    pts = _points("random", n=16, seed=5)
    goal = np.float32([200.0, 300.0])
    got = pf.compute_obs(t(pts), t(goal), params)
    ref = jf.compute_obs(jnp.asarray(pts), jnp.asarray(goal), jp)
    assert got.shape == (16, params.obs_dim)
    close(got, ref, "obs")
    batched = pf.compute_obs(t(pts)[None], t(goal)[None], params)
    assert torch.equal(got, batched[0])
    if obs_mode == "knn":
        sharded = pf.compute_obs_knn_sharded(t(pts)[None, 4:11], t(pts)[None],
                                             t(goal)[None], params, 4)
        jsharded = jf.compute_obs_knn_sharded(
            jnp.asarray(pts)[None, 4:11], jnp.asarray(pts)[None],
            jnp.asarray(goal)[None], jp, 4)
        close(sharded, jsharded, "sharded obs")
        assert torch.equal(sharded[0], got[4:11])


# ---------------------------------------------------------------------------
# One formation's reset and step, the padded env, pursuit, scenarios
# ---------------------------------------------------------------------------

CONFIGS = {
    "ring_obstacles": EnvParams(num_agents=6, num_obstacles=2, max_steps=4),
    "knn": EnvParams(num_agents=12, obs_mode="knn", knn_k=3, max_steps=4),
    "nonstrict_goal": EnvParams(num_agents=5, strict_parity=False,
                                goal_termination=True, max_steps=5,
                                close_goal_dist=400.0),
}


def _compare_step(port, ref, params, i, reward_tol=1e-6, exact=True):
    """``exact=False``: positions and the index columns within the float
    tolerance (the scenario layers perturb velocities and observations,
    as ``test_torch_scenarios.py`` holds them)."""
    (state, tr), (jstate, jtr) = port, ref
    same(tr.done, jtr.done, f"done {i}")
    same(state.steps, jstate.steps, f"steps {i}")
    (same if exact else close)(state.agents, jstate.agents, f"agents {i}")
    close(state.goal, jstate.goal, f"goal {i}")
    close(state.obstacles, jstate.obstacles, f"obstacles {i}")
    np.testing.assert_allclose(tr.reward.numpy(), np.asarray(jtr.reward),
                               rtol=1e-6, atol=reward_tol,
                               err_msg=f"reward {i}")
    if params.obs_mode == "knn" and exact:
        k = params.knn_k
        same(tr.obs[..., -k:], jtr.obs[..., -k:], f"obs idx {i}")
        close(tr.obs[..., :-k], jtr.obs[..., :-k], f"obs {i}")
    else:
        close(tr.obs, jtr.obs, f"obs {i}")
    assert set(tr.metrics) == set(jtr.metrics)
    for key, v in jtr.metrics.items():
        assert tr.metrics[key].shape == ()
        np.testing.assert_allclose(float(tr.metrics[key]), float(v),
                                   rtol=1e-6, atol=reward_tol, err_msg=key)


def _drive(params, jp, jreset, jstep, preset, pstep, steps=7, seed=0):
    """``steps`` steps of one formation through both packages from one JAX
    key, through a reset (max_steps 4 or 5), the port's resets injected
    from the JAX state's key."""
    rng = np.random.default_rng(seed)
    jstate = jreset(jax.random.PRNGKey(seed), jp)
    state = preset(jax_uniforms(jax.random.PRNGKey(seed), params))
    dones = 0
    for i in range(steps):
        vel = rng.normal(0, 8, (params.num_agents, 2)).astype(np.float32)
        fresh = reset(params, uniforms=jax_uniforms(jstate.key, params))
        jstate, jtr = jstep(jstate, jnp.asarray(vel), jp)
        state, tr = pstep(state, t(vel), params, fresh=fresh)
        yield (state, tr), (jstate, jtr), i
        dones += int(tr.done)
    assert dones >= 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reset_and_step_match_jax(name):
    params = CONFIGS[name]
    jp = jax_params(params)
    # JAX's reset(key) draws from split(key, 4)[1:], as jax_reset_uniforms.
    jstate = jf.reset(jax.random.PRNGKey(1), jp)
    state = reset(params, uniforms=jax_uniforms(jax.random.PRNGKey(1),
                                                params))
    for f in ("agents", "goal", "obstacles", "steps"):
        same(getattr(state, f), getattr(jstate, f), f)
    for port, ref, i in _drive(
            params, jp, jf.reset, jax.jit(jf.step, static_argnums=2),
            lambda u: reset(params, uniforms=u), step):
        _compare_step(port, ref, params, i)


def test_hetero_reset_and_step_match_jax():
    params = EnvParams(num_agents=8, num_obstacles=3, max_steps=4)
    jp = jax_params(params)
    key = jax.random.PRNGKey(4)
    jstate = jh.hetero_reset(key, jp, jnp.int32(5), jnp.int32(2))
    state = hetero_reset(params, 5, 2, uniforms=jax_uniforms(key, params))
    for f in ("agents", "goal", "obstacles", "steps", "n_agents",
              "n_obstacles"):
        same(getattr(state, f), getattr(jstate, f), f)
    jstep = jax.jit(jh.hetero_step, static_argnums=2)
    rng = np.random.default_rng(2)
    for i in range(7):
        vel = rng.normal(0, 8, (8, 2)).astype(np.float32)
        fresh = reset(params, uniforms=jax_uniforms(jstate.key, params))
        jstate, jtr = jstep(jstate, jnp.asarray(vel), jp)
        state, tr = hetero_step(state, t(vel), params, fresh=fresh)
        _compare_step((state, tr), (jstate, jtr), params, i)
        same(state.n_agents, jstate.n_agents, "n_agents")
        same(tr.obs[5:], np.zeros((3, params.obs_dim)), "padded obs")


@pytest.mark.parametrize("obs_mode", ["ring", "knn"])
def test_pursuit_step_matches_jax(obs_mode):
    params = PursuitParams(num_agents=6, num_obstacles=2, max_steps=4,
                           obs_mode=obs_mode, knn_k=2)
    jp = jax_pursuit(params)
    jstep = jax.jit(jpursuit.pursuit_step, static_argnums=2)
    for port, ref, i in _drive(params, jp, jf.reset, jstep,
                               lambda u: reset(params, uniforms=u),
                               pursuit_step, seed=3):
        _compare_step(port, ref, params, i, reward_tol=reward_atol(params))


@pytest.mark.parametrize("name", ["storm", "goal_switch", "comm_dropout"])
def test_scenario_step_matches_jax(name):
    params = EnvParams(num_agents=7, num_obstacles=2, max_steps=4,
                       obs_mode="knn", knn_k=3)
    jp = jax_params(params)
    jsp = jsc.scenario_params_for(name, 0.8)
    sp = sc.scenario_params_for(name, 0.8)
    jstate = jf.reset(jax.random.PRNGKey(6), jp)
    streams = JaxStreams(jstate.key[None], np.asarray(jstate.steps)[None],
                         params)
    state = formation_row(sc.init_scenario_state(
        batch_of_one(reset(params, uniforms=jax_uniforms(
            jax.random.PRNGKey(6), params))), params, streams))
    jstep = jax.jit(jsc.scenario_step, static_argnums=3)
    rng = np.random.default_rng(6)
    dones = 0
    for i in range(7):
        vel = rng.normal(0, 6, (7, 2)).astype(np.float32)
        fresh = formation_row(streams.fresh())
        jstate, jtr = jstep(jstate, jnp.asarray(vel), jsp, jp)
        state, tr = sc.scenario_step(state, t(vel), sp, params, None,
                                     streams, fresh=fresh)
        _compare_step((state, tr), (jstate, jtr), params, i, exact=False)
        same(tr.obs == 0, np.asarray(jtr.obs) == 0, f"blanked {i}")
        dones += int(tr.done)
    assert dones == 1


# ---------------------------------------------------------------------------
# EnvSpec's per-formation views
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec_name", ["formation", "pursuit_evasion"])
def test_spec_reset_env_and_step_env_match_jax(spec_name):
    spec, jspec = envs.get(spec_name), jenvs.get(spec_name)
    params = spec.default_params(num_agents=5, num_obstacles=1)
    jp = (jax_pursuit(params) if spec_name == "pursuit_evasion"
          else jax_params(params))
    jstate, jobs = jspec.reset_env(jax.random.PRNGKey(2), jp)
    state, obs = spec.reset_env(params, torch.Generator().manual_seed(2),
                                "cpu")
    for f in ("agents", "goal", "obstacles", "steps"):
        assert getattr(state, f).shape == getattr(jstate, f).shape, f
    assert obs.shape == jobs.shape
    assert torch.equal(obs, spec.obs(state, params))
    # A step that does not reset: both packages from the JAX state.
    vel = np.random.default_rng(1).normal(0, 5, (5, 2)).astype(np.float32)
    got = spec.step_env(to_port_one(jstate), t(vel), params)
    ref = jspec.step_env(jstate, jnp.asarray(vel), jp)
    same(got[0].agents, ref[0].agents, "agents")
    close(got[1], ref[1], "obs")
    pursuit = spec_name == "pursuit_evasion"
    np.testing.assert_allclose(
        got[2].numpy(), np.asarray(ref[2]), rtol=1e-6,
        atol=reward_atol(params) if pursuit else 1e-6)
    same(got[3], ref[3], "done")
    assert set(got[4]) == set(ref[4])
    assert spec.reset is reset  # pursuit resets as a formation, as JAX's


# ---------------------------------------------------------------------------
# One formation == its row of the batch, bitwise
# ---------------------------------------------------------------------------

ROW_CASES = {
    "ring": (EnvParams(num_agents=5, num_obstacles=2, max_steps=3), step,
             step_batch),
    "knn": (EnvParams(num_agents=10, obs_mode="knn", knn_k=3, max_steps=3),
            step, step_batch),
    "pursuit_knn": (PursuitParams(num_agents=8, obs_mode="knn", knn_k=2,
                                  max_steps=3), pursuit_step,
                    pursuit_step_batch),
}


def _assert_row(one, batch, i):
    (s1, t1), (sb, tb) = one, batch
    for f in dataclasses.fields(s1):
        assert torch.equal(getattr(s1, f.name), getattr(sb, f.name)[i]), f
    for f in ("obs", "reward", "done"):
        assert torch.equal(getattr(t1, f), getattr(tb, f)[i]), f
    for k, v in tb.metrics.items():
        assert torch.equal(t1.metrics[k], v[i]), k


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_step_equals_its_row_of_step_batch(case):
    params, one_step, batch_step = ROW_CASES[case]
    m = 4
    gen = torch.Generator().manual_seed(7)
    batch = reset_batch(params, m, gen, "cpu")
    rows = [formation_row(batch, i) for i in range(m)]
    for s in range(6):
        vel = torch.randn((m, params.num_agents, 2), generator=gen) * 8
        fresh = reset_batch(params, m, gen, "cpu")
        batch_next = batch_step(batch, vel, params, fresh=fresh)
        for i in range(m):
            one = one_step(rows[i], vel[i], params,
                           fresh=formation_row(fresh, i))
            _assert_row(one, batch_next, i)
            rows[i] = one[0]
        batch = batch_next[0]
    # A batch of one from one generator seed, no injection.
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    one, batch = reset(params, g1, "cpu"), reset_batch(params, 1, g2, "cpu")
    for s in range(5):
        vel = torch.randn((1, params.num_agents, 2),
                          generator=torch.Generator().manual_seed(s)) * 8
        out_one = one_step(one, vel[0], params, g1)
        out_batch = batch_step(batch, vel, params, g2)
        _assert_row(out_one, out_batch, 0)
        one, batch = out_one[0], out_batch[0]


JAX_ONE_STEP = {"ring": (jf.step, jax_params), "knn": (jf.step, jax_params),
                "pursuit_knn": (jpursuit.pursuit_step, jax_pursuit)}


@pytest.mark.parametrize("case", sorted(JAX_ONE_STEP))
def test_step_without_obs_is_zero_width_as_jax(case):
    """``with_obs=False`` gives JAX's zero-width ``(N, 0)`` observation;
    every other output is the full step's bitwise."""
    params, one_step, _ = ROW_CASES[case]
    jstep, to_jax = JAX_ONE_STEP[case]
    n = params.num_agents
    state = reset(params, torch.Generator().manual_seed(1), "cpu")
    vel = torch.randn((n, 2), generator=torch.Generator().manual_seed(0)) * 8
    full = one_step(state, vel, params, torch.Generator().manual_seed(2))
    bare = one_step(state, vel, params, torch.Generator().manual_seed(2),
                    with_obs=False)
    jp = to_jax(params)
    _, jtr = jstep(jf.reset(jax.random.PRNGKey(0), jp), jnp.asarray(vel),
                   jp, with_obs=False)
    assert bare[1].obs.shape == jtr.obs.shape == (n, 0)
    assert bare[1].obs.dtype == torch.float32 and jtr.obs.dtype == jnp.float32
    assert full[1].obs.shape == (n, params.obs_dim)
    for f in dataclasses.fields(full[0]):
        assert torch.equal(getattr(bare[0], f.name), getattr(full[0], f.name))
    for f in ("reward", "done"):
        assert torch.equal(getattr(bare[1], f), getattr(full[1], f)), f
    assert bare[1].metrics.keys() == full[1].metrics.keys()
    for k, v in full[1].metrics.items():
        assert torch.equal(bare[1].metrics[k], v), k


def test_hetero_step_equals_its_row():
    params = EnvParams(num_agents=6, num_obstacles=2, max_steps=2)
    gen = torch.Generator().manual_seed(1)
    counts = torch.tensor([3, 6], dtype=torch.int32)
    batch = hetero_reset_batch(params, counts, torch.tensor([0, 2]), gen,
                               "cpu")
    rows = [formation_row(batch, i) for i in range(2)]
    for s in range(4):
        vel = torch.randn((2, 6, 2), generator=gen) * 8
        fresh = reset_batch(params, 2, gen, "cpu")
        out = hetero_step_batch(batch, vel, params, fresh=fresh)
        for i in range(2):
            one = hetero_step(rows[i], vel[i], params,
                              fresh=formation_row(fresh, i))
            _assert_row(one, out, i)
            rows[i] = one[0]
        batch = out[0]


def test_top_level_exports_the_single_formation_api():
    assert mdf.reset is reset and mdf.step is step
    assert mdf.make_vec_env is pf.make_vec_env
    assert {"EnvParams", "FormationState", "Transition"} <= set(dir(mdf))
    with pytest.raises(ValueError, match="k < N"):
        knn_local(torch.zeros(2, 2), torch.zeros(3, 2), 3, 0)
