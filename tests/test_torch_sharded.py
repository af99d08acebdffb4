"""The port's slice-backed big-rung engine (``serving/sharded.py``) and
the fleet's sharded replica on the CPU, held against the JAX package.

The same weights (through ``params_to_jax`` / ``build_model``) and rows go
through JAX's ``ShardedPolicyEngine`` on ``make_mesh({"dp": dp})`` over
conftest's virtual CPU devices and through the port's on a slice of
``dp`` row blocks on the CPU device: deterministic actions agree within
``rtol=1e-5, atol=1e-6`` (the frameworks sum the matmuls in different
orders), for the MLP and a small GNN (N=8, k=4). The leaves an ``mp``
axis splits equal JAX's ``param_specs`` leaf for leaf; ``fit_spec_to_mesh``
and ``match_partition_rules`` answer as JAX's; bf16 rungs stay within
``tests/bf16_budget.py``'s bound and are not f32; the refusals are JAX's,
in its words. The fleet routes big requests to the slice, gives it its
own window, and lands a coordinated swap on it.
"""

import ast
import json
import re
from pathlib import Path
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP

from bf16_budget import bf16_action_atol
from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
)
from marl_distributedformation_tpu.models import (
    GNNActorCritic as JaxGNN,
    MLPActorCritic as JaxMLP,
)
from marl_distributedformation_tpu.parallel.mesh import make_mesh
from marl_distributedformation_tpu.serving import (
    ShardedPolicyEngine as JaxShardedEngine,
)
from marl_distributedformation_tpu.serving.sharded import (
    fit_spec_to_mesh as jax_fit_spec,
    match_partition_rules as jax_match_rules,
)
from marl_distributedformation_tpu_torch import serve as serve_cli
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.compat.policy import (
    LoadedPolicy,
    build_model,
)
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    Tracer,
    set_registry,
    set_tracer,
)
from marl_distributedformation_tpu_torch.obs.export import (
    prometheus_exposition,
)
from marl_distributedformation_tpu_torch.serving import (
    BucketedPolicyEngine,
    ShardedPolicyEngine,
    ShardedSpec,
)
from marl_distributedformation_tpu_torch.serving.fleet import (
    FleetReloadCoordinator,
    FleetRouter,
    warmup_fleet,
)
from marl_distributedformation_tpu_torch.serving.sharded import (
    P,
    ServingSlice,
    fit_spec_to_mesh,
    jax_path,
    make_shard_and_gather_fns,
    make_slice,
    match_partition_rules,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
OBS_DIM = 6
HIDDEN = (8, 8)
BUCKETS = (8, 64, 512)
RTOL, ATOL = 1e-5, 1e-6
N_AGENTS, K = 8, 4
GNN_OBS_DIM = 4 + 4 * K  # compute_obs_knn with the goal: 2 + 3k + 2 + k


@pytest.fixture(autouse=True)
def private_planes():
    """A fresh metrics registry and tracer a test (fleet snapshots record
    gauges process-wide)."""
    registry, tracer = set_registry(MetricsRegistry()), set_tracer(Tracer())
    yield
    set_registry(registry)
    set_tracer(tracer)


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


def _knn_rows(n, seed=0):
    """Whole formations of k-NN observations with valid neighbour
    indices."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, N_AGENTS, GNN_OBS_DIM - K)).astype(np.float32)
    idx = np.stack([rng.permutation(N_AGENTS)[:K]
                    for _ in range(n * N_AGENTS)]).reshape(n, N_AGENTS, K)
    return np.concatenate([feats, idx.astype(np.float32)], -1)


MODELS = {
    # name: (JAX module, policy name, model kwargs, rows, buckets)
    "mlp": (lambda: JaxMLP(act_dim=2, hidden=HIDDEN), "MLPActorCritic",
            {"hidden": HIDDEN}, _obs, BUCKETS),
    "gnn": (lambda: JaxGNN(k=K, act_dim=2), "GNNActorCritic", {"k": K},
            _knn_rows, (8, 64)),
}


def _policies(name, seed=3):
    """``(JAX policy, port policy)`` over the same weights."""
    make, policy_name, kwargs, rows, _ = MODELS[name]
    variables = make().init(jax.random.PRNGKey(seed), jnp.asarray(rows(1)))
    params = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
    env = SimpleNamespace(knn_k=K, goal_in_obs=True)
    model = build_model(policy_name, params["params"], env_params=env)
    return (JaxLoadedPolicy(params, policy=policy_name, model_kwargs=kwargs),
            LoadedPolicy(model))


def _slice(axes):
    return make_slice(axes, ["cpu"])


# ---------------------------------------------------------------------------
# Actions against JAX's sharded engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, dp", [("mlp", 2), ("mlp", 4), ("gnn", 2)])
def test_sharded_actions_match_jax(name, dp):
    """Every rung and a request larger than the top one: the port's slice
    of ``dp`` row blocks on the CPU against JAX's engine on a ``dp`` mesh
    of virtual CPU devices; one build a rung on each side."""
    jax_policy, policy = _policies(name)
    _, _, _, rows, buckets = MODELS[name]
    want_engine = JaxShardedEngine(jax_policy, make_mesh({"dp": dp}),
                                   buckets=buckets)
    engine = ShardedPolicyEngine(policy, _slice({"dp": dp}), buckets=buckets)
    for n in (*buckets, 5, buckets[-1] + 8):
        obs = rows(n, seed=n)
        got = engine.act(obs, deterministic=True)
        want = np.asarray(want_engine.act(obs, deterministic=True))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} dp={dp} n={n}")
    assert engine.compile_counts() == dict.fromkeys(buckets, 1)
    assert want_engine.compile_counts() == dict.fromkeys(buckets, 1)


def test_row_blocks_equal_the_single_engine_at_their_rows():
    """A row block of ``b/dp`` rows is the single engine's rung of
    ``b/dp`` rows: bitwise, both action modes at deterministic; the whole
    rung against the single engine's rung ``b`` within serving's
    tolerance. Stochastic actions come from each row block's generator
    and stay finite within the action space."""
    _, policy = _policies("mlp")
    dp = 4
    engine = ShardedPolicyEngine(policy, _slice({"dp": dp}), buckets=BUCKETS,
                                 seed=5)
    single = BucketedPolicyEngine(policy, buckets=tuple(
        b // dp for b in BUCKETS) + BUCKETS, seed=5)
    for b in BUCKETS:
        obs = _obs(b, seed=b)
        got = engine.act(obs, deterministic=True)
        h = b // dp
        for d in range(dp):
            assert np.array_equal(got[d * h:(d + 1) * h],
                                  single.act(obs[d * h:(d + 1) * h])), (b, d)
        np.testing.assert_allclose(got, single.act(obs), rtol=RTOL, atol=ATOL)
        sampled = engine.act(obs, deterministic=False)
        assert np.isfinite(sampled).all() and np.abs(sampled).max() <= 1.0
        assert not np.array_equal(sampled, got)
    assert engine.compile_counts() == dict.fromkeys(BUCKETS, 1)


def test_mp_axis_splits_jax_leaves_and_stays_within_fp_noise():
    """A dp x mp slice splits tower kernels over their OUTPUT features: the
    split leaves are JAX's ``param_specs``' leaf for leaf, and the actions
    stay within JAX's mp gate (atol 1e-5) of the single engine, and within
    serving's tolerance of JAX's dp x mp engine."""
    jax_policy, policy = _policies("mlp")
    mesh = {"dp": 2, "mp": 2}
    want_engine = JaxShardedEngine(jax_policy, make_mesh(mesh), buckets=(8,))
    engine = ShardedPolicyEngine(policy, _slice(mesh), buckets=(8,))
    jax_specs = {
        "/".join(str(getattr(e, "key", e)) for e in path): tuple(spec)
        for path, spec in jax.tree_util.tree_flatten_with_path(
            want_engine.param_specs, is_leaf=lambda x: isinstance(x, JaxP))[0]
    }
    got_specs = {f"params/{jax_path(n)}": tuple(s)
                 for n, s in engine.param_specs.items()}
    assert got_specs == jax_specs
    split = sorted(n for n, s in engine.param_specs.items() if "mp" in s)
    assert split == sorted(n for n in policy.params
                           if re.match(r"(pi|vf)_\d+\.", n))
    obs = _obs(8)
    single = BucketedPolicyEngine(policy, buckets=(8,))
    got = engine.act(obs, deterministic=True)
    np.testing.assert_allclose(got, single.act(obs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_engine.act(obs)),
                               rtol=RTOL, atol=ATOL)
    # The placed blocks gather back to the served parameters.
    gathered = engine.gather_params(engine._own)
    assert all(torch.equal(gathered[n], policy.params[n]) for n in gathered)


def test_bf16_rungs_within_cast_rounding_budget():
    """bf16 rungs compute in bf16 (the divergence is nonzero) within
    ``tests/bf16_budget.py``'s bound of the f32 ladder."""
    _, policy = _policies("mlp")
    replicated = BucketedPolicyEngine(policy, buckets=BUCKETS)
    bf16 = ShardedPolicyEngine(policy, _slice({"dp": 4}), buckets=BUCKETS,
                               dtype="bfloat16")
    assert bf16.dtype_label == "bf16"
    atol = bf16_action_atol(num_layers=len(HIDDEN) + 1)
    for n in BUCKETS:
        obs = _obs(n, seed=n)
        a16 = bf16.act(obs, deterministic=True)
        assert a16.dtype == np.float32
        diff = np.max(np.abs(replicated.act(obs) - a16))
        assert 0.0 < diff <= atol, (n, diff, atol)


def test_sharded_engine_rejects_what_jax_rejects():
    """JAX's refusals, in JAX's words: no 'dp' axis, a bucket that does not
    divide by dp. The port's own: parameters split over 'dp', and a
    snapshot not placed on the slice."""
    jax_policy, policy = _policies("mlp")
    for make, engine_cls, mesh in (
            (make_mesh, JaxShardedEngine, jax_policy),
            (_slice, ShardedPolicyEngine, policy)):
        with pytest.raises(ValueError, match="needs a 'dp' mesh axis") as a:
            engine_cls(mesh, make({"sp": 2}), buckets=(8,))
        with pytest.raises(ValueError, match="must divide by dp=4") as b:
            engine_cls(mesh, make({"dp": 4}), buckets=(6,))
        if engine_cls is JaxShardedEngine:
            want = (str(a.value), str(b.value))
        else:
            assert (str(a.value), str(b.value)) == want
    with pytest.raises(ValueError, match="replicates parameters over 'dp'"):
        ShardedPolicyEngine(policy, _slice({"dp": 2}), buckets=(8,),
                            rules=((r".*", P("dp")),))
    engine = ShardedPolicyEngine(policy, _slice({"dp": 2}), buckets=(8,))
    with pytest.raises(ValueError, match="placed on its slice"):
        engine.act(_obs(2), nn_params=policy.params)


# ---------------------------------------------------------------------------
# Partition rules against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec, shape, axes", [
    ((None, "mp"), (8, 8), {"dp": 4}),
    (("dp",), (8, 6), {"dp": 4}),
    (("dp",), (6, 8), {"dp": 4}),
    ((None, "mp"), (8, 6), {"dp": 2, "mp": 2}),
    ((None, "mp"), (8, 5), {"dp": 2, "mp": 2}),
    (("mp", None), (4, 4), {"dp": 1, "mp": 4}),
    ((), (3,), {"dp": 2}),
])
def test_fit_spec_to_mesh_matches_jax(spec, shape, axes):
    got = fit_spec_to_mesh(P(*spec), shape, _slice(axes))
    want = jax_fit_spec(JaxP(*spec), shape, make_mesh(axes))
    assert isinstance(got, P) and tuple(got) == tuple(want)


PARAMS = {"tower": {"kernel": np.ones((4, 4), np.float32),
                    "bias": np.ones((4,), np.float32)},
          "log_std": np.zeros((2,), np.float32),
          "scalar": np.ones((1,), np.float32)}


@pytest.mark.parametrize("rules, axes", [
    (((r"kernel", ("dp",)), (r".*", ())), {"dp": 2}),
    (((r"kernel", (None, "mp")), (r"bias", ("mp",)), (r".*", ())),
     {"dp": 2, "mp": 2}),
    (((r"tower", ("mp",)), (r".*", ())), {"dp": 2, "mp": 4}),
    (((r"nomatch", ()),), {"dp": 2}),
])
def test_match_partition_rules_matches_jax(rules, axes):
    def run(match, spec_cls, mesh):
        try:
            return match(tuple((r, spec_cls(*s)) for r, s in rules), PARAMS,
                         mesh), None
        except ValueError as e:
            return None, str(e)

    got, got_err = run(match_partition_rules, P, _slice(axes))
    want, want_err = run(jax_match_rules, JaxP, make_mesh(axes))
    assert got_err == want_err
    if want is not None:
        flat = lambda t: {k: tuple(v) for k, v in (  # noqa: E731
            (f"{a}/{b}", s) for a, sub in t.items()
            for b, s in (sub.items() if isinstance(sub, dict)
                         else [("", sub)]))}
        assert flat(got) == flat(want)


def test_shard_and_gather_fns_round_trip():
    """Shard functions place each leaf once a row block (a split leaf as its
    mp blocks of output features); gather functions bring it back."""
    mesh = ServingSlice({"dp": 2, "mp": 2}, ["cpu"])
    leaves = {"pi_0.weight": torch.arange(24.0).reshape(6, 4),
              "pi_0.bias": torch.arange(6.0), "log_std": torch.zeros(2)}
    specs = {"pi_0.weight": P(None, "mp"), "pi_0.bias": P("mp"),
             "log_std": P()}
    shard, gather = make_shard_and_gather_fns(specs, mesh)
    placed = {n: shard[n](t) for n, t in leaves.items()}
    assert len(placed["pi_0.weight"]) == 2
    assert [p.shape for p in placed["pi_0.weight"][0]] == [(3, 4), (3, 4)]
    assert len(placed["log_std"][1]) == 1
    for n, t in leaves.items():
        assert torch.equal(gather[n](placed[n]), t)
        assert placed[n][0][0].data_ptr() != t.data_ptr()


# ---------------------------------------------------------------------------
# The fleet's sharded replica
# ---------------------------------------------------------------------------


def test_router_routes_big_rungs_to_the_sharded_replica():
    """Big requests land on the slice, small ones on the replicas, and the
    rung gauges surface both kinds through the Prometheus folding."""
    _, policy = _policies("mlp")
    router = FleetRouter(policy, devices=["cpu"], num_replicas=2,
                         buckets=(1, 8, 64, 512), window_ms=0.0,
                         sharded=ShardedSpec(axis_sizes={"dp": 2},
                                             buckets=(64, 512)))
    with router:
        warmup_fleet(router, (OBS_DIM,))
        big = router.submit(_obs(64), timeout_s=30.0).result(60.0)
        small = router.submit(_obs(1), timeout_s=30.0).result(60.0)
        assert big.replica == router.sharded_replica.index
        assert small.replica != router.sharded_replica.index
        snap = router.metrics.snapshot(router.replicas)
    assert snap["rung64_f32_sharded"] == 1.0
    assert snap["rung512_f32_sharded"] == 1.0
    assert snap["rung64_f32_sharded_compiles"] == 1.0
    assert snap["rung64_f32_replicated_compiles"] == 1.0
    assert snap["rung512_f32_sharded_compiles"] == 1.0
    text = prometheus_exposition(snap)
    assert 'marl_rung_compiles{dtype="f32",kind="sharded",rung="64"}' in text
    assert router.compile_counts()[2] == {64: 1, 512: 1}


def test_router_gives_the_sharded_lane_its_own_window_and_refuses_lanes():
    """``ShardedSpec.window_ms`` overrides the fleet window for the slice's
    scheduler only; lanes over a slice are refused in JAX's words."""
    _, policy = _policies("mlp")
    spec = ShardedSpec(axis_sizes={"dp": 2}, buckets=(64,), min_rows=64,
                       window_ms=0.0)
    with FleetRouter(policy, devices=["cpu"], num_replicas=1,
                     buckets=(1, 64), window_ms=2.0, sharded=spec) as router:
        by_kind = {r.kind: r for r in router.replicas}
        assert by_kind["sharded"].scheduler.window_s == 0.0
        assert by_kind["replicated"].scheduler.window_s == 0.002
    with pytest.raises(ValueError, match="tenant lanes over the sharded"):
        FleetRouter(policy, devices=["cpu"], sharded=spec,
                    lanes={"a": (policy.params, 0)})


def test_coordinated_swap_lands_on_the_slice(tmp_path):
    """A checkpoint committed at the fleet barrier is placed on the slice
    once and served by both replica kinds: the slice's actions equal the
    new policy's, and both report the new step."""
    _, policy = _policies("mlp", seed=3)
    _, newer = _policies("mlp", seed=4)
    name = "MLPActorCritic"
    save_checkpoint(tmp_path, 1, {"policy": name, "num_timesteps": 1,
                                  "params": params_to_jax(policy.params, name)})
    router = FleetRouter(policy, devices=["cpu"], num_replicas=1,
                         buckets=(1, 8, 64), window_ms=0.0, initial_step=1,
                         sharded=ShardedSpec(axis_sizes={"dp": 2},
                                             buckets=(64,)))
    coordinator = FleetReloadCoordinator(tmp_path, router)
    with router:
        warmup_fleet(router, (OBS_DIM,))
        save_checkpoint(tmp_path, 2, {
            "policy": name, "num_timesteps": 2,
            "params": params_to_jax(newer.params, name)})
        assert coordinator.refresh(), list(coordinator.load_errors)
        obs = _obs(64, seed=9)
        big = router.submit(obs, timeout_s=30.0).result(60.0)
        small = router.submit(obs[:1], timeout_s=30.0).result(60.0)
    assert big.replica == router.sharded_replica.index
    assert big.model_step == small.model_step == 2
    want = BucketedPolicyEngine(newer, buckets=(64,)).act(obs)
    np.testing.assert_allclose(big.actions, want, rtol=RTOL, atol=ATOL)
    assert router.compile_counts()[1] == {64: 1}
    fleet_params, step = router.fleet_params()
    assert step == 2 and torch.equal(fleet_params["pi_0.weight"],
                                     newer.params["pi_0.weight"])


# ---------------------------------------------------------------------------
# The serve CLI: --sharded/--bf16/--mesh-devices/--record-trace, --slo-bench
# ---------------------------------------------------------------------------

SERVE_POLICY = REPO / "scripts" / "serve_policy.py"


def jax_report_keys(function):
    """The constant keys of ``report`` in ``function`` of the JAX script
    ``scripts/serve_policy.py``: its initial dict literal and every
    ``report["..."] =`` (an AST scan, no JAX bench runs)."""
    tree = ast.parse(SERVE_POLICY.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (isinstance(target, ast.Name) and target.id == "report"
                        and isinstance(node.value, ast.Dict)):
                    keys |= {k.value for k in node.value.keys
                             if isinstance(k, ast.Constant)}
                if (isinstance(target, ast.Subscript)
                        and getattr(target.value, "id", None) == "report"
                        and isinstance(target.slice, ast.Constant)):
                    keys.add(target.slice.value)
    return keys


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_cli_sharded_fleet_records_its_trace(tmp_path, capsys):
    """``--fleet --sharded --mesh-devices 2 --bf16 --record-trace``: the
    fleet smoke over two replicas and a bf16 dp=2 slice on the CPU, one
    build a rung a replica, and the offered arrivals saved as a trace
    ``load_trace`` replays."""
    from marl_distributedformation_tpu_torch.serving.loadgen import (
        load_trace,
    )

    trace = tmp_path / "trace.jsonl"
    rc = serve_cli.main([
        "--init-policy", "MLPActorCritic", "--obs-dim", "8", "--fleet",
        "--replicas", "2", "--sharded", "--mesh-devices", "2", "--bf16",
        "--record-trace", str(trace), "--duration", "0.5", "--device", "cpu",
    ])
    report = _last_json(capsys)
    assert rc == 0 and report["client_requests_ok"] > 0
    assert report["replicas"] == 3.0  # two replicas and the slice
    assert report["max_compiles_per_rung"] == 1.0
    assert len(load_trace(trace).sizes) > 1


def test_serve_cli_slo_bench(capsys):
    """``--slo-bench`` at a small size on the CPU: every key of the JAX
    bench's report, the big rung served by all three fleets, one build a
    rung everywhere."""
    rc = serve_cli.main([
        "--init-policy", "MLPActorCritic", "--obs-dim", "8", "--slo-bench",
        "--replicas", "2", "--duration", "0.4", "--slo-passes", "1",
        "--slo-iterations", "1", "--load-rps", "40", "--device", "cpu",
    ])
    report = _last_json(capsys)
    assert rc == 0, report
    missing = jax_report_keys("_run_slo_bench") - set(report)
    assert not missing, missing
    for label in ("replicated", "sharded", "bf16"):
        assert report[f"{label}_512_p95_ms"] > 0, report
    assert report["max_compiles_per_rung"] == 1
    assert report["mesh_devices"] == 2
