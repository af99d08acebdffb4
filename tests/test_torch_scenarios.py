"""The port's scenario engine against the JAX package on the CPU.

The JAX package derives every layer's draws from the formation's key
(``fold_in(key, salt)`` an episode, folded with ``steps`` a step); the port
draws from its own stream (``scenarios/engine.py``). Here the port's layers
get the JAX package's draws (``JaxStreams``, which tracks the keys as the
JAX step moves them), and the env's resets are injected as in
``test_torch_env.py``.

Tolerances: masks (frozen agents, dropped and occluded neighbor blocks),
``done``, ``steps``, the knn index columns and every severity-0 comparison
bitwise; other floats within ``rtol=1e-6`` plus ``atol=1e-6`` near 0 (XLA
may contract ``goal + speed * heading`` into an FMA, and ``cos``/``sin``
and norms may differ in the last bit), and ``rtol=1e-5`` for closed-loop
episode metrics, as in ``test_torch_eval.py``.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu import scenarios as jsc
from marl_distributedformation_tpu.env.formation import (
    compute_obs as jax_compute_obs,
    reset_batch as jax_reset_batch,
)
from marl_distributedformation_tpu.eval import (
    baseline_act_fn as jax_baseline_act_fn,
    policy_act_fn as jax_policy_act_fn,
    run_episode_metrics as jax_run_episode_metrics,
)
from marl_distributedformation_tpu.models import GNNActorCritic as JaxGNN
from marl_distributedformation_tpu.models.gnn import (
    gather_nodes as jax_gather_nodes,
    parse_knn_obs as jax_parse_knn_obs,
)
from marl_distributedformation_tpu.scenarios import layers as jl
from marl_distributedformation_tpu.scenarios import registry as jreg
from marl_distributedformation_tpu_torch import scenarios as sc
from marl_distributedformation_tpu_torch.compat.convert import params_from_jax
from marl_distributedformation_tpu_torch.env import (
    EnvParams,
    FormationState,
    compute_obs,
    reset_batch,
    step_batch,
)
from marl_distributedformation_tpu_torch.eval import (
    baseline_act_fn,
    policy_act_fn,
    run_episode_metrics,
)
from marl_distributedformation_tpu_torch.models import GNNActorCritic
from marl_distributedformation_tpu_torch.models.gnn import (
    gather_nodes,
    parse_knn_obs,
)
from marl_distributedformation_tpu_torch.scenarios import engine
from marl_distributedformation_tpu_torch.scenarios import registry as preg
from marl_distributedformation_tpu_torch.scenarios.engine import (
    EpisodeDraws,
    ScenarioStreams,
    StepDraws,
)
from marl_distributedformation_tpu_torch.scenarios.params import FIELDS
from test_torch_env import jax_params, jax_reset_uniforms, to_port
from test_torch_models import np_tree

RTOL = ATOL = 1e-6
NAMES = tuple(s.name for s in preg._DEFAULT_SPECS)
OBSTACLE_SCENARIOS = ("obstacle_field", "moving_obstacles")
TWO_PI = 2.0 * jnp.pi


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, ref, what, rtol=RTOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=ATOL, err_msg=what)


def same(port, ref, what):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# The JAX package's draws
# ---------------------------------------------------------------------------


def _episode_key(key, salt):
    return jax.random.fold_in(key, salt)


def _step_key(key, salt, steps):
    return jax.random.fold_in(_episode_key(key, salt), steps)


@functools.lru_cache(maxsize=None)
def _episode_fn(n, k, d):
    def one(key):
        return (
            jax.random.uniform(_episode_key(key, jl._SALT_FAULT), (n,),
                               jnp.float32),
            jax.random.uniform(_episode_key(key, jl._SALT_ACT_BIAS), (),
                               minval=0.0, maxval=TWO_PI),
            jax.random.uniform(_episode_key(key, jl._SALT_GOAL_DIR), (),
                               minval=0.0, maxval=TWO_PI),
            jax.random.uniform(_episode_key(key, jl._SALT_GOAL_SWITCH), (2,),
                               dtype=jnp.float32),
            jax.random.uniform(_episode_key(key, jl._SALT_OBSTACLE_DIR), (k,),
                               minval=0.0, maxval=TWO_PI),
            jax.random.normal(_episode_key(key, jl._SALT_OBS_BIAS), (d,)),
        )

    return jax.jit(jax.vmap(one))


@functools.lru_cache(maxsize=None)
def _step_fn(n, d):
    def one(key, s, next_key, next_s):
        return (
            jax.random.normal(_step_key(key, jl._SALT_ACT_NOISE, s), (n, 2)),
            jax.random.normal(_step_key(key, jl._SALT_GUST, s), (2,)),
            jax.random.normal(_step_key(next_key, jl._SALT_OBS_NOISE, next_s),
                              (n, d)),
            jax.random.uniform(_step_key(next_key, jl._SALT_COMM, next_s),
                               (n,), jnp.float32),
        )

    return jax.jit(jax.vmap(one))


def jax_episode_draws(keys, params: EnvParams) -> EpisodeDraws:
    """The per-episode draws of ``scenarios/layers.py`` from each
    formation's key (``bernoulli`` is ``uniform < p``)."""
    fn = _episode_fn(params.num_agents, params.num_obstacles, params.obs_dim)
    return EpisodeDraws(*map(t, fn(keys)))


def jax_step_draws(keys, steps, next_keys, next_steps,
                   params: EnvParams) -> StepDraws:
    """The per-step draws: actuator noise and gusts from the pre-step
    state's keys and counters, sensor noise and the comm-dropout uniforms
    from the post-step state's."""
    fn = _step_fn(params.num_agents, params.obs_dim)
    return StepDraws(*map(t, fn(keys, jnp.asarray(steps), next_keys,
                                jnp.asarray(next_steps))))


def jax_pre_draws(keys, steps, params: EnvParams):
    """``(act_noise (M,N,2), gust (M,2))`` of the pre-step state."""
    draws = jax_step_draws(keys, steps, keys, steps, params)
    return draws.act_noise, draws.gust


def jax_post_draws(keys, steps, params: EnvParams):
    """``(obs_noise (M,N,obs_dim), comm_u (M,N))`` of the post-step state."""
    draws = jax_step_draws(keys, steps, keys, steps, params)
    return draws.obs_noise, draws.comm_u


_split_first = jax.jit(jax.vmap(lambda k: jax.random.split(k, 4)[0]))


class JaxStreams(ScenarioStreams):
    """The JAX package's layer draws for a batch whose keys and step
    counters it tracks as the JAX step moves them: a key changes only at a
    reset (to ``split(key, 4)[0]``), and done follows the step counter
    (strict parity). ``fresh()`` is the env reset the JAX step draws from
    the current keys."""

    def __init__(self, keys, steps, params: EnvParams) -> None:
        super().__init__(None)
        self.keys = jnp.asarray(keys)
        self.steps = np.asarray(steps, np.int32)
        self.params = params

    def episode(self, params, m, device):
        return jax_episode_draws(self.keys, params)

    def step(self, params, m, device):
        done = self.steps > params.max_steps
        next_keys = jnp.where(jnp.asarray(done)[:, None],
                              _split_first(self.keys), self.keys)
        next_steps = np.where(done, 0, self.steps + 1).astype(np.int32)
        draws = jax_step_draws(self.keys, self.steps, next_keys, next_steps,
                               params)
        self.keys, self.steps = next_keys, next_steps
        return draws

    def fresh(self) -> FormationState:
        return reset_batch(self.params, self.keys.shape[0],
                           uniforms=jax_reset_uniforms(self.keys, self.params))


def injected_scenario_step(streams: JaxStreams, params: EnvParams, sp_fn):
    """An ``env_step_fn`` through the port's scenario step with the JAX
    package's layer draws and resets; ``sp_fn()`` gives the scenario
    params (read at every step, as the trainer's buffers are)."""

    def step(state, velocity):
        fresh = streams.fresh()
        return sc.scenario_step_batch(state, velocity, sp_fn(), params, None,
                                      streams, fresh=fresh)

    return step


def to_jax_sp(arrays):
    return jsc.ScenarioParams(**{f: jnp.asarray(v) for f, v in arrays.items()})


def to_port_sp(arrays):
    return sc.ScenarioParams(**{f: torch.from_numpy(np.array(v))
                                for f, v in arrays.items()})


def random_sp_arrays(m, seed=0, zero_share=0.3):
    """Per-formation magnitudes, each formation's layer off (exactly 0)
    with probability ``zero_share``; probabilities in [0, 1]."""
    rng = np.random.default_rng(seed)
    scale = {"fault_prob": 0.6, "act_noise_sigma": 4.0, "act_bias": 2.0,
             "wind": 4.0, "gust_sigma": 3.0, "goal_speed": 5.0,
             "goal_jump": 1.0, "obs_noise_sigma": 0.1, "obs_bias": 0.05,
             "comm_drop_prob": 0.7, "obstacle_speed": 3.0,
             "obstacle_occlusion": 150.0}
    out = {}
    for f in FIELDS:
        shape = (m, 2) if f == "wind" else (m,)
        v = rng.uniform(0.2, 1.0, shape).astype(np.float32) * scale[f]
        off = rng.uniform(size=(m,)) < zero_share
        v[off] = 0.0
        out[f] = v
    return out


def jax_state(params, m, seed=3, steps=None):
    jp = jax_params(params)
    state = jax_reset_batch(jax.random.PRNGKey(seed), jp, m)
    rng = np.random.default_rng(seed)
    agents = rng.uniform([0, 0], [params.width, params.height],
                         (m, params.num_agents, 2)).astype(np.float32)
    state = state.replace(agents=jnp.asarray(agents))
    if steps is not None:
        state = state.replace(steps=jnp.asarray(steps, jnp.int32))
    return jp, state


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_registry_contents_and_order_equal_jax():
    assert NAMES == tuple(s.name for s in jreg._DEFAULT_SPECS)
    assert preg.registered_scenarios()[:len(NAMES)] == NAMES
    for ours, ref in zip(preg._DEFAULT_SPECS, jreg._DEFAULT_SPECS):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("call", [
    lambda r: r.get_scenario("wnd"),
    lambda r: r.get_scenario("zzz"),
    lambda r: r.register_scenario(r.ScenarioSpec("wind")),
])
def test_registry_fail_fast_messages_equal_jax(call):
    with pytest.raises(ValueError) as ours:
        call(preg)
    with pytest.raises(ValueError) as ref:
        call(jreg)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("severity", [0.0, 0.5, 1.0, 2.5])
def test_build_bitwise_equal_jax(severity):
    for name in NAMES:
        ours = preg.get_scenario(name).build(severity)
        ref = jreg.get_scenario(name).build(severity)
        for f in FIELDS:
            same(getattr(ours, f), getattr(ref, f), f"{name}.{f}")
        assert getattr(ours, "wind").dtype == torch.float32


@pytest.mark.parametrize("severity", [-0.1, float("nan"), float("inf")])
def test_build_refusals_equal_jax(severity):
    with pytest.raises(ValueError) as ours:
        preg.get_scenario("wind").build(severity)
    with pytest.raises(ValueError) as ref:
        jreg.get_scenario("wind").build(severity)
    assert str(ours.value) == str(ref.value)
    specs = [preg.get_scenario(n) for n in ("wind", "storm")]
    with pytest.raises(ValueError, match=r"scenario batch over \[wind, storm"):
        preg.sample_scenario_batch(torch.Generator(), severity, [0.5, 0.5],
                                   specs, 4)


def test_sample_scenario_batch_choice_equals_jax():
    """With JAX's uniforms, the port's inverse-CDF draw picks the scenario
    ``jax.random.choice`` picks, and the batch's leaves are that
    scenario's, bitwise."""
    names = ("clean", "wind", "sensor_noise", "storm")
    probs = np.float32([0.0, 1 / 3, 1 / 3, 1 / 3])
    key = jax.random.PRNGKey(7)
    m = 64
    ref = jreg.sample_scenario_batch(
        key, jnp.float32(0.7), jnp.asarray(probs),
        tuple(jreg.get_scenario(n) for n in names), m)
    want = jax.random.choice(key, len(names), (m,), p=jnp.asarray(probs))
    u = t(jax.random.uniform(key, (m,), jnp.float32))
    got = preg.choice_indices(u, torch.from_numpy(probs))
    same(got, want, "indices")
    assert int((got == 0).sum()) == 0
    specs = [preg.get_scenario(n) for n in names]
    built = [s.build(np.float32(0.7)) for s in specs]
    for f in FIELDS:
        want_leaf = torch.stack([getattr(built[i], f) for i in got.tolist()])
        same(want_leaf, getattr(ref, f), f)
    batch = preg.sample_scenario_batch(torch.Generator().manual_seed(1),
                                       0.7, probs, specs, m)
    assert batch.wind.shape == (m, 2) and batch.fault_prob.shape == (m,)
    assert not bool((batch.obs_noise_sigma == 0).all() or
                    (batch.obs_noise_sigma > 0).all())


# ---------------------------------------------------------------------------
# Each layer, with the JAX package's draws
# ---------------------------------------------------------------------------

def _jax_layer(fn, batched):
    """The JAX layer vmapped over formations (its first ``batched``
    arguments), jitted with the env params static."""
    axes = (0,) * batched + (None,)
    return jax.jit(jax.vmap(fn, in_axes=axes), static_argnums=batched)


LAYER_PARAMS = {
    "ring": EnvParams(num_agents=6, num_obstacles=3, max_steps=8),
    "knn": EnvParams(num_agents=8, num_obstacles=3, max_steps=8,
                     obs_mode="knn", knn_k=3),
    "ring_no_goal": EnvParams(num_agents=6, num_obstacles=2, max_steps=8,
                              goal_in_obs=False),
}


@pytest.mark.parametrize("case", sorted(LAYER_PARAMS))
def test_pre_step_layers_match_jax(case):
    params = LAYER_PARAMS[case]
    m = 12
    # Half the formations at the switch step max_steps // 2.
    steps = np.where(np.arange(m) % 2 == 0, params.max_steps // 2, 1)
    jp, js = jax_state(params, m, steps=steps)
    arrays = random_sp_arrays(m, seed=1)
    jsp, sp = to_jax_sp(arrays), to_port_sp(arrays)
    state = to_port(js)
    ep = jax_episode_draws(js.key, params)

    goal = sc.perturb_goal(state, sp, params, ep.goal_theta, ep.switch_u)
    ref = _jax_layer(jl.perturb_goal, 2)(js, jsp, jp)
    close(goal, ref.goal, "goal")
    same(goal == state.goal, ref.goal == js.goal, "goal unchanged where off")

    obstacles = sc.perturb_obstacles(state, sp, params, ep.obstacle_theta)
    ref = _jax_layer(jl.perturb_obstacles, 2)(js, jsp, jp)
    close(obstacles, ref.obstacles, "obstacles")

    rng = np.random.default_rng(2)
    vel = rng.normal(0, 5, (m, params.num_agents, 2)).astype(np.float32)
    act_noise, gust = jax_pre_draws(js.key, js.steps, params)
    got = sc.perturb_velocity(torch.from_numpy(vel), sp, ep.fault_u,
                              act_noise, ep.act_theta, gust)
    ref = _jax_layer(jl.perturb_velocity, 3)(jnp.asarray(vel), js, jsp, jp)
    close(got, ref, "velocity")
    same(got == 0, np.asarray(ref) == 0, "frozen agents")
    off = arrays["fault_prob"] + arrays["act_noise_sigma"] + arrays[
        "act_bias"] + np.abs(arrays["wind"]).sum(-1) + arrays["gust_sigma"]
    same(got[off == 0], vel[off == 0], "velocity where every layer is off")


@pytest.mark.parametrize("case", sorted(LAYER_PARAMS))
def test_obs_layers_match_jax(case):
    params = LAYER_PARAMS[case]
    m = 12
    jp, js = jax_state(params, m, seed=4, steps=np.arange(m) % 5)
    # Pull some agents near obstacles so occlusion has work.
    agents = np.array(js.agents)
    agents[:, :2] = np.array(js.obstacles)[:, :1] + 3.0
    js = js.replace(agents=jnp.asarray(agents))
    arrays = random_sp_arrays(m, seed=5)
    jsp, sp = to_jax_sp(arrays), to_port_sp(arrays)
    state = to_port(js)
    obs_j = jax_compute_obs(js.agents, js.goal, jp)
    obs = t(obs_j)
    ep = jax_episode_draws(js.key, params)
    obs_noise, comm_u = jax_post_draws(js.key, js.steps, params)

    got = sc.perturb_obs(obs, state, sp, params, obs_noise, ep.obs_bias,
                         comm_u)
    ref = _jax_layer(jl.perturb_obs, 3)(obs_j, js, jsp, jp)
    close(got, ref, "obs")
    same(got == 0, np.asarray(ref) == 0, "blanked columns")

    occ = sc.occlude_obs(obs, state, sp, params)
    ref = _jax_layer(jl.occlude_obs, 3)(obs_j, js, jsp, jp)
    same(occ, ref, "occlusion")
    cols = sc.neighbor_obs_columns(params)
    np.testing.assert_array_equal(cols, jl.neighbor_obs_columns(jp))
    blanked = (occ == 0) & (obs != 0)
    assert bool(blanked.any()) and not bool(blanked[..., ~cols].any())


# ---------------------------------------------------------------------------
# The engine step
# ---------------------------------------------------------------------------

ENGINE_PARAMS = {
    "ring": EnvParams(num_agents=6, num_obstacles=3, max_steps=4),
    "knn": EnvParams(num_agents=8, num_obstacles=2, max_steps=4,
                     obs_mode="knn", knn_k=3),
}


def _engine_run(params, m, jsp_fn, sp, steps=9, seed=8):
    """The JAX scenario step against the port's with JAX's draws and
    resets injected, ``steps`` steps through a reset (max_steps 4)."""
    jp = jax_params(params)
    js = jax_reset_batch(jax.random.PRNGKey(seed), jp, m)
    streams = JaxStreams(js.key, js.steps, params)
    state = sc.init_scenario_state(to_port(js), params, streams)
    step = injected_scenario_step(streams, params, lambda: sp)
    jstep = jax.jit(jsc.scenario_step_batch, static_argnums=3)
    rng = np.random.default_rng(seed)
    dones = 0
    for i in range(steps):
        vel = rng.normal(0, 6, (m, params.num_agents, 2)).astype(np.float32)
        js, jtr = jstep(js, jnp.asarray(vel), jsp_fn(), jp)
        state, tr = step(state, torch.from_numpy(vel))
        same(tr.done, jtr.done, f"done {i}")
        same(state.steps, js.steps, f"steps {i}")
        close(state.agents, js.agents, f"agents {i}")
        close(state.goal, js.goal, f"goal {i}")
        close(state.obstacles, js.obstacles, f"obstacles {i}")
        close(tr.reward, jtr.reward, f"reward {i}")
        close(tr.obs, jtr.obs, f"obs {i}")
        same(tr.obs == 0, np.asarray(jtr.obs) == 0, f"blanked {i}")
        for key in jtr.metrics:
            close(tr.metrics[key], jtr.metrics[key], f"{key} {i}")
        dones += int(tr.done.sum())
    assert dones == m


@pytest.mark.parametrize("case", sorted(ENGINE_PARAMS))
def test_engine_step_mixed_batch_matches_jax(case):
    """A per-formation mix of every registered scenario (JAX's sampler's
    draw) through both engines."""
    params = ENGINE_PARAMS[case]
    m = 11
    specs = tuple(jreg.get_scenario(n) for n in NAMES)
    jsp = jreg.sample_scenario_batch(
        jax.random.PRNGKey(3), jnp.float32(1.0),
        jnp.full((len(NAMES),), 1 / len(NAMES), jnp.float32), specs, m)
    sp = to_port_sp({f: np.asarray(getattr(jsp, f)) for f in FIELDS})
    _engine_run(params, m, lambda: jsp, sp)


@pytest.mark.parametrize("name", ["storm", "goal_switch"])
def test_engine_step_one_scenario_matches_jax(name):
    """One formation's params for the whole batch (the eval shape)."""
    params = ENGINE_PARAMS["knn"]
    jsp = jreg.scenario_params_for(name, 0.8)
    sp = preg.scenario_params_for(name, 0.8)
    _engine_run(params, 3, lambda: jsp, sp)


# ---------------------------------------------------------------------------
# Severity 0 is the clean env, bitwise; severity 1 perturbs
# ---------------------------------------------------------------------------

CLEAN_CASES = {
    "ring": EnvParams(num_agents=5, max_steps=5),
    "ring_obstacles": EnvParams(num_agents=5, num_obstacles=3, max_steps=5),
    "knn": EnvParams(num_agents=7, max_steps=5, obs_mode="knn", knn_k=3),
    "knn_obstacles": EnvParams(num_agents=7, num_obstacles=3, max_steps=5,
                               obs_mode="knn", knn_k=3),
}


def _trajectories(params, sp, steps=14, m=4, seed=0):
    """The clean run and the scenario run from one env seed, with the same
    actions: lists of (state tensors, obs, reward, done) a step."""
    rng = np.random.default_rng(seed)
    vels = [torch.from_numpy(rng.normal(0, 6, (m, params.num_agents, 2))
                             .astype(np.float32)) for _ in range(steps)]
    runs = []
    for scenario in (False, True):
        gen = torch.Generator().manual_seed(seed)
        state = reset_batch(params, m, gen, "cpu")
        if scenario:
            streams = ScenarioStreams(torch.Generator().manual_seed(99))
            state = sc.init_scenario_state(state, params, streams)
        out = []
        for vel in vels:
            if scenario:
                state, tr = sc.scenario_step_batch(state, vel, sp, params,
                                                   gen, streams)
            else:
                state, tr = step_batch(state, vel, params, gen)
            out.append([state.agents, state.goal, state.obstacles,
                        state.steps, tr.obs, tr.reward, tr.done,
                        *tr.metrics.values()])
        runs.append(out)
    return runs


def _bitwise(a, b):
    return all(torch.equal(x, y) and (x.dtype != torch.float32 or torch.equal(
        torch.signbit(x), torch.signbit(y))) for x, y in zip(a, b))


@pytest.mark.parametrize("case", sorted(CLEAN_CASES))
@pytest.mark.parametrize("name", NAMES)
def test_severity_zero_is_the_clean_env_bitwise(name, case):
    params = CLEAN_CASES[case]
    clean, scen = _trajectories(params, preg.scenario_params_for(name, 0.0))
    assert sum(int(s[6].sum()) for s in clean) == 8  # resets on the way
    for i, (a, b) in enumerate(zip(clean, scen)):
        assert _bitwise(a, b), f"{name} at severity 0 differs at step {i}"


@pytest.mark.parametrize("name", [n for n in NAMES if n != "clean"])
def test_severity_one_perturbs(name):
    base = CLEAN_CASES["knn_obstacles"]
    clean, scen = _trajectories(base, preg.scenario_params_for(name, 1.0))
    assert not all(_bitwise(a, b) for a, b in zip(clean, scen)), name
    if name in OBSTACLE_SCENARIOS:
        # The obstacle layers are the identity without obstacles.
        plain = base.replace(num_obstacles=0)
        clean, scen = _trajectories(plain,
                                    preg.scenario_params_for(name, 1.0))
        assert all(_bitwise(a, b) for a, b in zip(clean, scen)), name


def test_scenario_episode_draws_follow_the_episode():
    """Episode draws stay put within an episode and are fresh after a
    reset, before the observation layer reads them; step draws are fresh
    every step; the env's generator is not drawn from."""
    params = EnvParams(num_agents=5, max_steps=2)
    m = 3
    gen = torch.Generator().manual_seed(0)
    state = sc.init_scenario_state(
        reset_batch(params, m, gen, "cpu"), params,
        ScenarioStreams(torch.Generator().manual_seed(1)))
    streams = ScenarioStreams(torch.Generator().manual_seed(2))
    sp = preg.scenario_params_for("sensor_noise", 1.0)
    first = state.obs_bias.clone()
    for i in range(4):
        env_before = gen.get_state()
        state, tr = sc.scenario_step_batch(state, torch.zeros(m, 5, 2), sp,
                                           params, gen, streams)
        clean_gen = torch.Generator().manual_seed(0)
        clean_gen.set_state(env_before)
        reset_batch(params, m, clean_gen, "cpu")
        assert torch.equal(gen.get_state(), clean_gen.get_state())
        if i < 3:
            assert torch.equal(state.obs_bias, first)
    assert bool(tr.done.all()) and not torch.equal(state.obs_bias, first)


# ---------------------------------------------------------------------------
# Evaluation under a scenario, against the JAX package
# ---------------------------------------------------------------------------

def _gnn_pair(params):
    jmodel = JaxGNN(k=params.knn_k)
    obs = jnp.zeros((1, params.num_agents, params.obs_dim), jnp.float32)
    jvars = jmodel.init(jax.random.PRNGKey(5), obs)
    model = GNNActorCritic(k=params.knn_k)
    model.load_state_dict(params_from_jax(np_tree(jvars), "GNNActorCritic"))
    return jmodel, jvars, model.eval()


@pytest.mark.parametrize("name,policy", [
    ("storm", "gnn"), ("comm_dropout", "gnn"), ("moving_goal", "baseline"),
])
def test_scenario_eval_matches_jax(name, policy):
    params = EnvParams(num_agents=8, obs_mode="knn", knn_k=3, max_steps=20)
    jp = jax_params(params)
    m, seed = 4, 1234
    if policy == "gnn":
        jmodel, jvars, model = _gnn_pair(params)
        jact = jax_policy_act_fn(jmodel, jvars, jp)
        act = policy_act_fn(model, params)
    else:
        jact, act = jax_baseline_act_fn(jp), baseline_act_fn(params)
    ref = jax.jit(
        jax_run_episode_metrics,
        static_argnames=("act_fn", "params", "num_formations"),
    )(jax.random.PRNGKey(seed), act_fn=jact, params=jp, num_formations=m,
      scenario_params=jreg.scenario_params_for(name, 0.7))
    js = jax_reset_batch(jax.random.PRNGKey(seed), jp, m)
    got = run_episode_metrics(
        act, params, m, initial_state=to_port(js),
        scenario_params=preg.scenario_params_for(name, 0.7),
        scenario_streams=JaxStreams(js.key, js.steps, params))
    assert float(got["episodes"]) == float(ref["episodes"]) == m
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

SCEN100 = ("[{rollouts: 12, scenarios: [clean]}, {rollouts: 12, scenarios: "
           "[wind, sensor_noise, actuator_fault], severity: 0.5}, "
           "{rollouts: 6, scenarios: [storm], severity: 1.0}]")
SCHEDULE_CFGS = {
    "scen100": (SCEN100, 0.5),
    "names": ("[wind, sensor_noise]", 0.6),
    "parsed_ramp": ([{"rollouts": 5, "scenarios": ["wind"],
                      "severity": 1.0, "severity_start": 0.2},
                     {"rollouts": 1, "scenarios": ["storm", "clean"]}], 0.3),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CFGS))
def test_schedule_matches_jax(case):
    cfg, default = SCHEDULE_CFGS[case]
    ours = sc.schedule_from_cfg(cfg, default_severity=default)
    ref = jsc.schedule_from_cfg(cfg, default_severity=default)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.names == ref.names
    assert ours.total_rollouts == ref.total_rollouts
    total = ours.total_rollouts + 3  # past the end holds the last stage
    for r in range(total):
        assert ours.severity_at(r) == ref.severity_at(r)
        np.testing.assert_array_equal(ours.probs_at(r), ref.probs_at(r))
    for r0, k in ((0, total), (3, 4), (total - 2, 5)):
        np.testing.assert_array_equal(ours.severity_chunk(r0, k),
                                      ref.severity_chunk(r0, k))
        np.testing.assert_array_equal(ours.probs_chunk(r0, k),
                                      ref.probs_chunk(r0, k))
        np.testing.assert_array_equal(
            ours.severity_chunk(r0, k),
            np.float32([ours.severity_at(r) for r in range(r0, r0 + k)]))


@pytest.mark.parametrize("cfg", [
    "[]", "[wind, {rollouts: 2, scenarios: [wind]}]",
    "[{rollouts: 2, scenarios: [wind], sevrity: 1}]",
    "[{rollouts: 0, scenarios: [wind]}]", "[wnd]",
    "[{rollouts: 2, scenarios: [wind], severity: -1}]",
])
def test_schedule_refusals_equal_jax(cfg):
    with pytest.raises(ValueError) as ours:
        sc.schedule_from_cfg(cfg)
    with pytest.raises(ValueError) as ref:
        jsc.schedule_from_cfg(cfg)
    assert str(ours.value) == str(ref.value)


def test_from_falsifiers_matches_jax(monkeypatch):
    """Derived ``adv:`` specs and the auto-curriculum stage, from the gate's
    record dicts and from objects, as the JAX package builds them (each
    package's registry restored after)."""
    from marl_distributedformation_tpu.scenarios import schedule as jsched
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule as psched,
    )

    for mod in (preg, jreg):
        monkeypatch.setattr(mod, "_REGISTRY", dict(mod._REGISTRY))
    for mod in (psched, jsched):
        monkeypatch.setattr(mod, "register_scenario",
                            getattr(preg if mod is psched else jreg,
                                    "register_scenario"))

    class Falsifier:
        def __init__(self, scenario, severity):
            self.scenario, self.severity = scenario, severity

    falsifiers = [{"scenario": "wind", "severity": 0.8},
                  Falsifier("sensor_noise", 1.7),
                  {"scenario": "wind", "severity": 1.2}]
    ours = sc.from_falsifiers(falsifiers, rollouts=7, severity_scale=0.5)
    ref = jsc.from_falsifiers(falsifiers, rollouts=7, severity_scale=0.5)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.names == ("adv:wind", "adv:sensor_noise", "clean")
    for name in ours.names:
        assert dataclasses.asdict(preg.get_scenario(name)) == \
            dataclasses.asdict(jreg.get_scenario(name))
        for f in FIELDS:
            same(getattr(preg.get_scenario(name).build(1.0), f),
                 getattr(jreg.get_scenario(name).build(1.0), f), f)
    for bad in ([], [{"scenario": "wind", "severity": 0.0}],
                [{"scenario": "wnd", "severity": 1.0}]):
        with pytest.raises(ValueError) as a:
            sc.from_falsifiers(bad)
        with pytest.raises(ValueError) as b:
            jsc.from_falsifiers(bad)
        assert str(a.value) == str(b.value)
    assert sc.ADV_SCENARIO_PREFIX == jsc.ADV_SCENARIO_PREFIX


# ---------------------------------------------------------------------------
# The GNN's neighbor indices where noise pushes them out of range
# ---------------------------------------------------------------------------

OUT_OF_RANGE = np.float32([-0.5, -1.3, -7.2, -7.9, -8.0, -9.5, 7.9, 8.0,
                           8.5, np.nan, 1e10, -1e10, np.inf, -np.inf, 2.99,
                           0.0, -0.0, 3.0])


def test_gnn_index_handling_matches_jax_out_of_range():
    """Index columns truncated toward zero (NaN to 0), ``[-N, -1]`` counted
    from the end, and anything further a NaN neighbor, as the JAX
    package's ``astype(int32)`` and ``take_along_axis`` make them: the
    port's NaN distances fall exactly where JAX gathers NaN rows, the
    other neighbors gather JAX's rows, and a GNN forward with noised
    indices agrees (NaN where JAX's is)."""
    params = EnvParams(num_agents=8, obs_mode="knn", knn_k=3)
    m, n, k = 3, params.num_agents, params.knn_k
    rng = np.random.default_rng(0)
    obs = rng.normal(0, 0.3, (m, n, params.obs_dim)).astype(np.float32)
    obs[..., -k:] = rng.choice(OUT_OF_RANGE, (m, n, k))
    h = rng.normal(size=(m, n, 5)).astype(np.float32)
    _, jedge, jidx = jax_parse_knn_obs(jnp.asarray(obs), k)
    _, edge, idx = parse_knn_obs(torch.from_numpy(obs), k)
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    got = gather_nodes(torch.from_numpy(h), idx).numpy()
    want = np.asarray(jax_gather_nodes(jnp.asarray(h), jidx))
    fill = np.isnan(want).all(-1)
    np.testing.assert_array_equal(np.isnan(edge[..., 2].numpy()), fill)
    assert fill.any() and not fill.all()
    np.testing.assert_array_equal(got[~fill], want[~fill])
    np.testing.assert_array_equal(edge[..., :2].numpy(),
                                  np.asarray(jedge)[..., :2])

    jmodel, jvars, model = _gnn_pair(params)
    jmean, _, jvalue = jmodel.apply(jvars, jnp.asarray(obs))
    with torch.no_grad():
        mean, _, value = model(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=1e-5,
                               atol=1e-6)
    # In-range (noised but truncating inside [0, N-1]) indices are finite.
    obs[..., -k:] = np.clip(obs[..., -k:], 0.0, n - 0.01)
    obs[..., -k:] = np.nan_to_num(obs[..., -k:], nan=1.0)
    with torch.no_grad():
        assert bool(torch.isfinite(model(torch.from_numpy(obs))[0]).all())


def test_sensor_noise_trajectory_through_the_gnn_is_finite():
    """A GNN acting on observations with sensor noise and comm dropout at
    severity 2 steps without raising (the indices stay gatherable)."""
    params = EnvParams(num_agents=8, obs_mode="knn", knn_k=3, max_steps=6)
    model = GNNActorCritic(k=3, generator=torch.Generator().manual_seed(0))
    for name in ("sensor_noise", "comm_dropout", "storm"):
        sp = preg.scenario_params_for(name, 2.0)
        out = run_episode_metrics(policy_act_fn(model, params), params, 4,
                                  device="cpu", scenario_params=sp)
        assert math.isfinite(float(out["episode_return_per_agent"]))


def test_compute_obs_layout_columns_cover_the_index_block():
    """The knn neighbor mask covers the trailing index columns (the
    declared second range), so dropout blanks the indices too."""
    params = EnvParams(num_agents=8, obs_mode="knn", knn_k=3)
    cols = sc.neighbor_obs_columns(params)
    assert cols[-3:].all() and not cols[:2].any()
    state = reset_batch(params, 2, torch.Generator().manual_seed(0), "cpu")
    obs = compute_obs(state.agents, state.goal, params)
    sp = preg.scenario_params_for("comm_dropout", 2.0)  # p clipped to 1
    out = sc.perturb_obs(obs, state, sc.broadcast_params(sp, 2), params,
                         torch.zeros_like(obs), torch.zeros(2, obs.shape[-1]),
                         torch.zeros(2, 8))
    assert bool((out[..., cols] == 0).all())
    assert torch.equal(out[..., ~cols], obs[..., ~cols])


def test_engine_streams_draw_the_same_amount_every_step():
    """A step always draws its step draws and a batch of fresh episode
    draws, so the layers' generator moves the same amount every step,
    done or not, and a run is a pure function of its seeds."""
    params = EnvParams(num_agents=5, max_steps=1)
    gen = torch.Generator().manual_seed(0)
    streams = ScenarioStreams(torch.Generator().manual_seed(3))
    state = sc.init_scenario_state(reset_batch(params, 2, gen, "cpu"),
                                   params, streams)
    offsets = []
    for _ in range(4):
        before = streams.generator.get_state().clone()
        state, tr = sc.scenario_step_batch(
            state, torch.zeros(2, 5, 2), preg.scenario_params_for("wind", 1),
            params, gen, streams)
        probe = torch.Generator()
        probe.set_state(before)
        streams_probe = ScenarioStreams(probe)
        streams_probe.step(params, 2, torch.device("cpu"))
        streams_probe.episode(params, 2, torch.device("cpu"))
        offsets.append(torch.equal(probe.get_state(),
                                   streams.generator.get_state()))
    assert all(offsets)
    assert engine.EPISODE_FIELDS == tuple(
        f.name for f in dataclasses.fields(EpisodeDraws))
