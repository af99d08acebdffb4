"""The port's serving stack (``marl_distributedformation_tpu_torch/serving``)
on the CPU: against the JAX package's ``BucketedPolicyEngine``, and the
port's counterpart of every test in ``tests/test_serving.py``.

The same numpy rows go through JAX's engine and the port's, the weights
carried across by ``compat/convert.py``: deterministic actions within
``rtol=1e-5, atol=1e-6`` (as ``tests/test_serving.py`` holds the engine
against ``LoadedPolicy.predict``; the two frameworks sum the matmuls in
different orders) at every rung and on a request larger than the top rung,
for the MLP, CTDE and GNN; ``plan``, ``bucket_for`` and padded capacity
exactly equal. Stochastic actions are the port's own draws (not JAX's):
they are held for freshness and spread. The scheduler tests bound counts
and invariants, not wall time under load.
"""

import json
import random
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
)
from marl_distributedformation_tpu.models import (
    CTDEActorCritic as JaxCTDE,
    GNNActorCritic as JaxGNN,
    MLPActorCritic as JaxMLP,
)
from marl_distributedformation_tpu.serving import (
    BucketedPolicyEngine as JaxEngine,
    ServingMetrics as JaxServingMetrics,
)
from marl_distributedformation_tpu_torch import serve as serve_cli
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.compat.policy import (
    LoadedPolicy,
    build_model,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu_torch.models import (
    CTDEActorCritic,
    GNNActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.serving import (
    BackpressureError,
    BucketedPolicyEngine,
    MicroBatchScheduler,
    ModelRegistry,
    RequestTimeout,
    ServedResult,
    ServingClient,
    ServingMetrics,
    backoff_s,
    run_smoke_benchmark,
)
from marl_distributedformation_tpu_torch.utils.config import load_config
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_state_dict_partial,
    save_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent
OBS_DIM = 6
HIDDEN = (8, 8)
RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"


def _make_policy(seed=0, hidden=HIDDEN, obs_dim=OBS_DIM):
    model = MLPActorCritic(
        obs_dim, act_dim=2, hidden=hidden,
        generator=torch.Generator().manual_seed(seed),
    )
    return LoadedPolicy(model.eval())


def _write_ckpt(log_dir, step, policy):
    """A trainer-shaped checkpoint file (policy name + parameters in the
    JAX package's layout)."""
    name = type(policy.model).__name__
    return save_checkpoint(
        log_dir, step,
        {"policy": name, "params": params_to_jax(policy.params, name),
         "num_timesteps": step},
    )


def _obs(n, seed=0):
    return (
        np.random.default_rng(seed)
        .standard_normal((n, OBS_DIM))
        .astype(np.float32)
    )


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Parity with the JAX package's engine
# ---------------------------------------------------------------------------

N_AGENTS, K = 6, 2
GNN_OBS_DIM = 4 + 4 * K  # compute_obs_knn with the goal: 2 + 3k + 2 + k
BUCKETS = (1, 8, 64)
# One size a rung, a partial rung, and one larger than the top rung
# (64 + 64 + a bucketed remainder of 2 on the 8-rung).
SIZES = (1, 5, 8, 40, 64, 130)


def _knn_rows(n, seed):
    """Whole formations of k-NN observations with valid neighbor
    indices."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, N_AGENTS, GNN_OBS_DIM - K)).astype(np.float32)
    idx = np.stack([rng.permutation(N_AGENTS)[:K]
                    for _ in range(n * N_AGENTS)]).reshape(n, N_AGENTS, K)
    return np.concatenate([feats, idx.astype(np.float32)], -1)


MODELS = {
    # name: (JAX module, port policy name, row shape, rows)
    "mlp": (lambda: JaxMLP(act_dim=2, hidden=HIDDEN), "MLPActorCritic",
            (OBS_DIM,), lambda n, s: _obs(n, s)),
    "ctde": (lambda: JaxCTDE(act_dim=2, hidden=HIDDEN), "CTDEActorCritic",
             (N_AGENTS, OBS_DIM),
             lambda n, s: np.random.default_rng(s).standard_normal(
                 (n, N_AGENTS, OBS_DIM)).astype(np.float32)),
    "gnn": (lambda: JaxGNN(k=K, act_dim=2), "GNNActorCritic",
            (N_AGENTS, GNN_OBS_DIM), _knn_rows),
}


@pytest.fixture(scope="module")
def engines():
    """``{model: (JAX engine, port engine)}`` over the same weights."""
    out = {}
    for name, (make, policy_name, row_shape, rows) in MODELS.items():
        module = make()
        variables = module.init(jax.random.PRNGKey(3),
                                jnp.asarray(rows(1, 0)))
        params = jax.tree_util.tree_map(
            np.asarray, flax.core.unfreeze(variables))
        kwargs = {"k": K} if name == "gnn" else {"hidden": HIDDEN}
        jax_policy = JaxLoadedPolicy(params, policy=policy_name,
                                     model_kwargs=kwargs)
        env = SimpleNamespace(knn_k=K, goal_in_obs=True)
        model = build_model(policy_name, params["params"], env_params=env)
        out[name] = (JaxEngine(jax_policy, buckets=BUCKETS),
                     BucketedPolicyEngine(LoadedPolicy(model),
                                          buckets=BUCKETS))
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_engine_matches_the_jax_engine(engines, model, n):
    jax_engine, engine = engines[model]
    rows = MODELS[model][3](n, 100 + n)
    got = engine.act(rows, deterministic=True)
    want = np.asarray(jax_engine.act(rows, deterministic=True))
    assert got.shape == want.shape == (n, *MODELS[model][2][:-1], 2)
    _close(got, want)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_engine_builds_once_a_rung_like_the_jax_engine(engines, model):
    jax_engine, engine = engines[model]
    for n in SIZES:
        rows = MODELS[model][3](n, n)
        engine.act(rows)
        jax_engine.act(rows)
    assert engine.compile_counts() == jax_engine.compile_counts() == {
        1: 1, 8: 1, 64: 1}


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 63, 64, 65, 127, 128, 129,
                               200, 513])
def test_plan_and_bucket_for_equal_the_jax_engine(n):
    policy = _make_policy()
    jax_policy = JaxLoadedPolicy(
        {"params": params_to_jax(policy.params, "MLPActorCritic")["params"]},
        model_kwargs={"hidden": HIDDEN},
    )
    for buckets in (BUCKETS, (1, 8, 64, 512), (4, 16)):
        port = BucketedPolicyEngine(policy, buckets=buckets)
        ref = JaxEngine(jax_policy, buckets=buckets)
        assert port.buckets == ref.buckets
        assert port.plan(n) == ref.plan(n)
        assert sum(port.plan(n)) == sum(ref.plan(n))  # padded capacity
        if n <= ref.max_bucket:
            assert port.bucket_for(n) == ref.bucket_for(n)
        else:
            with pytest.raises(ValueError, match="exceed the top bucket"):
                port.bucket_for(n)


def test_metrics_snapshot_keys_equal_the_jax_package():
    port, ref = ServingMetrics(), JaxServingMetrics()
    for m in (port, ref):
        m.record_submit(1)
        m.record_batch(3, 8, 0.001, [0.002, 0.003], 0)
    assert port.snapshot().keys() == ref.snapshot().keys()
    assert port.snapshot() == ref.snapshot()


def test_stochastic_actions_are_fresh_and_spread():
    """The port's draws are its own, not JAX's: held for freshness (two
    dispatches of the same rows differ) and spread (a unit-std Gaussian
    around the mean, clipped to [-1, 1])."""
    engine = BucketedPolicyEngine(_make_policy(), buckets=(512,), seed=5)
    rows = np.repeat(_obs(1, seed=1), 512, axis=0)
    mean = engine.act(rows[:1], deterministic=True)
    a1 = engine.act(rows, deterministic=False)
    a2 = engine.act(rows, deterministic=False)
    assert not np.allclose(a1, a2)
    assert np.abs(a1).max() <= 1.0
    # log_std is 0: about 32% of the draws clip at +-1, and the rest
    # spread around the mean.
    clipped = np.mean(np.abs(a1) == 1.0)
    assert 0.2 < clipped < 0.45
    assert 0.5 < a1.std(axis=0).min() < 0.9
    assert np.abs(np.median(a1, axis=0) - mean[0]).max() < 0.15


def test_bf16_ladder_within_the_cast_rounding_budget():
    """``tests/bf16_budget.py``'s budget for a depth-3 tanh-MLP, f32 at
    rest, cast inside the rung."""
    from bf16_budget import bf16_action_atol

    from marl_distributedformation_tpu_torch.device import resolve_device

    resolve_device("cpu")  # every entry point's device choice
    assert not (
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    policy = _make_policy(hidden=(64, 64))
    f32 = BucketedPolicyEngine(policy, buckets=(1, 8, 64))
    bf16 = BucketedPolicyEngine(policy, buckets=(1, 8, 64), dtype="bfloat16")
    assert (f32.dtype_label, bf16.dtype_label) == ("f32", "bf16")
    obs = _obs(70, seed=4)
    got = bf16.act(obs)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, f32.act(obs), rtol=0,
                               atol=bf16_action_atol(num_layers=3))
    assert not np.array_equal(got, f32.act(obs))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        BucketedPolicyEngine(policy, dtype="float16")


def test_trained_checkpoint_bf16_divergence_matches_the_jax_engine():
    """The committed (trained) MLP's bf16 ladder is off its f32 one by more
    than the budget, which is derived for a seeded-init MLP, in the JAX
    engine as in the port; the two divergences agree within 2x (each
    framework rounds bf16 at its own places)."""
    from bf16_budget import bf16_action_atol

    ckpt = REPO / "docs/acceptance/tpu_run/rl_model_20480000_steps.msgpack"
    rows = np.random.default_rng(0).uniform(-1, 1, (512, 8)).astype(
        np.float32)
    jax_policy = JaxLoadedPolicy.from_checkpoint(ckpt)
    ref = np.abs(
        np.asarray(JaxEngine(jax_policy, buckets=(512,)).act(rows))
        - np.asarray(JaxEngine(jax_policy, buckets=(512,),
                               dtype="bfloat16").act(rows))).max()
    policy = LoadedPolicy.from_checkpoint(ckpt, device=CPU)
    got = np.abs(
        BucketedPolicyEngine(policy, buckets=(512,)).act(rows)
        - BucketedPolicyEngine(policy, buckets=(512,),
                               dtype="bfloat16").act(rows)).max()
    budget = bf16_action_atol(num_layers=policy.model.depth + 1)
    assert ref > budget and got > budget
    assert 0.5 < got / ref < 2.0


def test_engine_refuses_a_snapshot_of_another_architecture():
    engine = BucketedPolicyEngine(_make_policy(), buckets=(8,))
    wide = _make_policy(hidden=(16, 16)).params
    with pytest.raises(ValueError, match="never changes the architecture"):
        engine.act(_obs(2), nn_params=wide)
    with pytest.raises(ValueError, match="differ from the served model"):
        engine.act(_obs(2), nn_params={"log_std": torch.zeros(2)})


def test_snapshot_copies_in_and_back():
    """A snapshot is copied into the served parameters; passing None
    again serves the wrapped policy's own; neither rebuilds a rung."""
    pol_a, pol_b = _make_policy(seed=0), _make_policy(seed=7)
    engine = BucketedPolicyEngine(pol_a, buckets=(8,))
    obs = _obs(3, seed=2)
    ref_a, _ = pol_a.predict(obs)
    ref_b, _ = pol_b.predict(obs)
    _close(engine.act(obs), ref_a)
    _close(engine.act(obs, nn_params=pol_b.params), ref_b)
    _close(engine.act(obs), ref_a)
    assert engine.compile_counts() == {8: 1}


# ---------------------------------------------------------------------------
# Engine: bucket ladder + build-once pin (tests/test_serving.py)
# ---------------------------------------------------------------------------


def test_engine_matches_loaded_policy_predict():
    policy = _make_policy()
    engine = BucketedPolicyEngine(policy, buckets=(1, 8, 64))
    for n in (1, 3, 8):
        obs = _obs(n, seed=n)
        ref, _ = policy.predict(obs, deterministic=True)
        _close(engine.act(obs, deterministic=True), ref)


def test_engine_mixed_stream_compiles_each_bucket_exactly_once():
    """Any mix of request sizes spanning the whole ladder costs exactly
    one build per rung, ever (a second build would raise)."""
    engine = BucketedPolicyEngine(
        _make_policy(), buckets=(1, 8, 64), max_traces_per_bucket=1
    )
    for i, (n, det) in enumerate(
        [(1, True), (2, True), (8, False), (9, True), (40, False),
         (64, True), (65, True), (130, False), (1, False), (5, True)]
    ):
        actions = engine.act(_obs(n, seed=i), deterministic=det)
        assert actions.shape == (n, 2)
        assert np.abs(actions).max() <= 1.0 + 1e-6
    assert engine.compile_counts() == {1: 1, 8: 1, 64: 1}


def test_engine_split_path_matches_direct_apply():
    policy = _make_policy()
    engine = BucketedPolicyEngine(policy, buckets=(1, 8, 64))
    obs = _obs(130, seed=3)
    ref, _ = policy.predict(obs, deterministic=True)
    _close(engine.act(obs), ref)


def test_engine_stochastic_draws_fresh_keys():
    engine = BucketedPolicyEngine(_make_policy(), buckets=(8,))
    obs = _obs(4, seed=1)
    a1 = engine.act(obs, deterministic=False)
    a2 = engine.act(obs, deterministic=False)
    assert not np.allclose(a1, a2), "same noise drawn twice"
    assert np.abs(a1).max() <= 1.0 + 1e-6


def test_engine_rejects_rowless_and_unbatched_obs():
    engine = BucketedPolicyEngine(_make_policy(), buckets=(8,))
    with pytest.raises(ValueError, match="leading batch axis"):
        engine.act(np.zeros(OBS_DIM, np.float32))
    with pytest.raises(ValueError, match="at least one row"):
        engine.act(np.zeros((0, OBS_DIM), np.float32))


# ---------------------------------------------------------------------------
# Scheduler: coalescing, backpressure, timeouts
# ---------------------------------------------------------------------------


def test_scheduler_coalesces_and_answers_each_request():
    policy = _make_policy()
    engine = BucketedPolicyEngine(policy, buckets=(1, 8, 64))
    sched = MicroBatchScheduler(engine, window_ms=10.0)
    sizes = [1, 3, 5, 8, 2, 7, 4, 6]
    with sched:
        futures = [
            sched.submit(_obs(n, seed=10 + i), deterministic=True)
            for i, n in enumerate(sizes)
        ]
        results = [f.result(timeout=30) for f in futures]
    for i, (n, res) in enumerate(zip(sizes, results)):
        ref, _ = policy.predict(_obs(n, seed=10 + i), deterministic=True)
        _close(res.actions, ref)
        assert res.latency_s >= 0.0
    m = sched.metrics
    assert m.requests_total == len(sizes)
    assert m.rows_total == sum(sizes)
    assert m.batches_total < len(sizes)
    assert m.padded_rows_total >= m.rows_total


def test_scheduler_mixed_deterministic_flags_split_correctly():
    policy = _make_policy()
    engine = BucketedPolicyEngine(policy, buckets=(1, 8, 64))
    with MicroBatchScheduler(engine, window_ms=10.0) as sched:
        f_det = sched.submit(_obs(3, seed=1), deterministic=True)
        f_sto = sched.submit(_obs(3, seed=1), deterministic=False)
        det = f_det.result(timeout=30).actions
        sto = f_sto.result(timeout=30).actions
    ref, _ = policy.predict(_obs(3, seed=1), deterministic=True)
    _close(det, ref)
    assert not np.allclose(sto, ref), "stochastic group got the mode action"


def _slow_engine(engine, delay_s):
    """Wrap engine.act with a delay so the worker stays busy and the queue
    actually fills."""
    orig = engine.act

    def slow_act(*args, **kwargs):
        time.sleep(delay_s)
        return orig(*args, **kwargs)

    engine.act = slow_act
    return engine


def test_scheduler_backpressure_rejects_with_retry_after():
    engine = _slow_engine(
        BucketedPolicyEngine(_make_policy(), buckets=(8,)), 0.2
    )
    with MicroBatchScheduler(engine, max_queue=2, window_ms=0.0) as sched:
        futures, rejected = [], None
        for i in range(10):
            try:
                futures.append(sched.submit(_obs(2, seed=i)))
            except BackpressureError as e:
                rejected = e
                break
        assert rejected is not None, "queue bound never engaged"
        assert rejected.retry_after_s > 0.0
        assert sched.metrics.rejected_total >= 1
        for f in futures:
            assert f.result(timeout=30).actions.shape == (2, 2)


def test_scheduler_expires_timed_out_requests():
    engine = _slow_engine(
        BucketedPolicyEngine(_make_policy(), buckets=(8,)), 0.25
    )
    with MicroBatchScheduler(engine, window_ms=0.0) as sched:
        blocker = sched.submit(_obs(1, seed=0))
        doomed = sched.submit(_obs(1, seed=1), timeout_s=0.01)
        with pytest.raises(RequestTimeout):
            doomed.result(timeout=30)
        assert blocker.result(timeout=30).actions.shape == (1, 2)
        assert sched.metrics.timeouts_total == 1


def test_scheduler_survives_mismatched_row_shapes():
    policy = _make_policy()
    engine = BucketedPolicyEngine(policy, buckets=(1, 8, 64))
    with MicroBatchScheduler(engine, window_ms=20.0) as sched:
        good = sched.submit(_obs(2, seed=1))
        bad = sched.submit(np.zeros((2, OBS_DIM + 1), np.float32))
        ref, _ = policy.predict(_obs(2, seed=1), deterministic=True)
        _close(good.result(timeout=30).actions, ref)
        with pytest.raises(Exception):
            bad.result(timeout=30)
        again = sched.submit(_obs(3, seed=2))
        assert again.result(timeout=30).actions.shape == (3, 2)


def test_malformed_first_request_does_not_poison_the_bucket():
    """The FIRST request to a rung is malformed: its failed build must not
    consume the budget-1 guard."""
    policy = _make_policy()
    engine = BucketedPolicyEngine(
        policy, buckets=(8,), max_traces_per_bucket=1
    )
    with pytest.raises(Exception):
        engine.act(np.zeros((2, OBS_DIM + 1), np.float32))
    assert engine.compile_counts() == {8: 0}, "a failed build is no build"
    obs = _obs(2, seed=1)
    ref, _ = policy.predict(obs, deterministic=True)
    _close(engine.act(obs), ref)
    assert engine.compile_counts() == {8: 1}
    with pytest.raises(ValueError, match="one compiled row shape"):
        engine.act(np.zeros((2, OBS_DIM + 1), np.float32))


# ---------------------------------------------------------------------------
# Registry: hot swap, version pinning, bad-checkpoint containment
# ---------------------------------------------------------------------------


def test_hot_swap_mid_stream_no_drops_no_recompiles(tmp_path):
    """A swap mid-stream changes subsequent actions, drops nothing, and
    reuses the built rungs (the snapshot is copied into the served
    parameters at the batch barrier)."""
    pol_a, pol_b = _make_policy(seed=0), _make_policy(seed=7)
    _write_ckpt(tmp_path, 100, pol_a)
    registry = ModelRegistry(tmp_path, device=CPU)
    engine = BucketedPolicyEngine(
        registry.policy, buckets=(1, 8, 64), max_traces_per_bucket=1
    )
    obs = _obs(5, seed=5)
    ref_a, _ = pol_a.predict(obs, deterministic=True)
    ref_b, _ = pol_b.predict(obs, deterministic=True)
    assert not np.allclose(ref_a, ref_b)

    with MicroBatchScheduler(engine, registry=registry, window_ms=1.0) as s:
        first = [s.submit(obs) for _ in range(8)]
        first_results = [f.result(timeout=30) for f in first]
        inflight = [s.submit(obs) for _ in range(8)]
        _write_ckpt(tmp_path, 200, pol_b)
        assert registry.refresh(), "newer checkpoint must swap"
        second = [s.submit(obs) for _ in range(8)]
        inflight_results = [f.result(timeout=30) for f in inflight]
        second_results = [f.result(timeout=30) for f in second]

    for res in first_results:
        assert res.model_step == 100
        _close(res.actions, ref_a)
    for res in inflight_results:
        assert res.model_step in (100, 200)
        _close(res.actions, ref_a if res.model_step == 100 else ref_b)
    steps = [r.model_step for r in first_results + inflight_results
             + second_results]
    assert steps == sorted(steps), "model_step went backward"
    for res in second_results:
        assert res.model_step == 200
        _close(res.actions, ref_b)
    assert registry.swap_count == 1
    assert all(c <= 1 for c in engine.compile_counts().values())


def test_registry_ignores_older_and_equal_steps(tmp_path):
    _write_ckpt(tmp_path, 50, _make_policy())
    registry = ModelRegistry(tmp_path, device=CPU)
    assert registry.active_step == 50
    assert not registry.refresh()
    _write_ckpt(tmp_path, 40, _make_policy(seed=9))
    assert not registry.refresh()
    assert registry.active_step == 50


def test_registry_keeps_serving_on_mismatched_architecture(tmp_path):
    _write_ckpt(tmp_path, 10, _make_policy(hidden=(8, 8)))
    registry = ModelRegistry(tmp_path, device=CPU)
    params_before, step_before = registry.active()
    _write_ckpt(tmp_path, 20, _make_policy(hidden=(16, 16)))
    assert not registry.refresh()
    assert registry.active_step == step_before == 10
    assert registry.active()[0] is params_before
    assert len(registry.load_errors) == 1
    path, err = registry.load_errors[0]
    assert "rl_model_20_steps" in path
    assert "architecture mismatch" in err


def test_registry_with_prebuilt_policy_upgrades_to_disk(tmp_path):
    _write_ckpt(tmp_path, 200, _make_policy(seed=3))
    registry = ModelRegistry(tmp_path, policy=_make_policy(seed=0))
    assert registry.active_step == 0
    assert registry.refresh()
    assert registry.active_step == 200


def test_registry_params_live_on_device(tmp_path):
    """Swapped params are tensors on the registry's device (one upload at
    swap time), not the read-only numpy views msgpack restores."""
    _write_ckpt(tmp_path, 1, _make_policy(seed=0))
    registry = ModelRegistry(tmp_path, device=CPU)
    _write_ckpt(tmp_path, 2, _make_policy(seed=1))
    assert registry.refresh()
    params = registry.active()[0]
    assert set(params) == set(registry.policy.params)
    assert all(isinstance(x, torch.Tensor) and x.device == registry.device
               for x in params.values())


def test_registry_rejects_same_shape_dtype_drift(tmp_path):
    _write_ckpt(tmp_path, 10, _make_policy())
    registry = ModelRegistry(tmp_path, device=CPU)
    drifted = _make_policy(seed=2)
    tree = params_to_jax(drifted.params, "MLPActorCritic")
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)
    save_checkpoint(tmp_path, 20, {"policy": "MLPActorCritic",
                                   "params": tree, "num_timesteps": 20})
    assert not registry.refresh()
    assert registry.active_step == 10
    assert "dtype" in registry.load_errors[0][1]


def test_registry_background_watcher_swaps(tmp_path):
    _write_ckpt(tmp_path, 1, _make_policy(seed=0))
    registry = ModelRegistry(tmp_path, poll_interval_s=0.05, device=CPU)
    with registry:
        _write_ckpt(tmp_path, 2, _make_policy(seed=1))
        deadline = time.time() + 10.0
        while registry.active_step != 2 and time.time() < deadline:
            time.sleep(0.02)
    assert registry.active_step == 2
    assert registry.swap_count == 1


def test_registry_refuses_another_policy_class(tmp_path):
    _write_ckpt(tmp_path, 1, _make_policy())
    registry = ModelRegistry(tmp_path, device=CPU)
    save_checkpoint(tmp_path, 2, {"policy": "CTDEActorCritic",
                                  "params": {}, "num_timesteps": 2})
    assert not registry.refresh()
    assert "trained with policy 'CTDEActorCritic'" in (
        registry.load_errors[0][1])


# ---------------------------------------------------------------------------
# Checkpoint hot-reload edges (utils.checkpoint)
# ---------------------------------------------------------------------------


def test_latest_checkpoint_never_observes_partial_writes(tmp_path):
    target = {"params": {"w": np.arange(50_000, dtype=np.float32)}}
    done = threading.Event()

    def writer():
        for step in range(1, 120):
            save_checkpoint(tmp_path, step, target)
        done.set()

    t = threading.Thread(target=writer)
    t.start()
    reads = 0
    try:
        while not done.is_set():
            path = latest_checkpoint(tmp_path)
            if path is None:
                continue
            raw = load_checkpoint_raw(path)  # raises on a torn file
            assert "params" in raw
            reads += 1
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    assert reads > 0, "reader never overlapped the writer"


def test_latest_checkpoint_skips_temp_files(tmp_path):
    save_checkpoint(tmp_path, 7, {"x": np.zeros(3)})
    (tmp_path / ".rl_model_999_steps.msgpack.tmp").write_bytes(b"torn")
    (tmp_path / "rl_model_888_steps.msgpack.tmp").write_bytes(b"torn")
    found = latest_checkpoint(tmp_path)
    assert found is not None and found.name == "rl_model_7_steps.msgpack"


def _template(policy):
    return {"params": params_to_jax(policy.params, "MLPActorCritic")}


def test_restore_partial_mismatched_shapes_is_a_clean_error(tmp_path):
    path = _write_ckpt(tmp_path, 5, _make_policy(hidden=(8, 8)))
    template = _template(_make_policy(hidden=(16, 16)))
    with pytest.raises(ValueError, match="architecture mismatch") as e:
        restore_state_dict_partial(load_checkpoint_raw(path), template,
                                   origin=str(path))
    assert "pi_0" in str(e.value)
    assert "rl_model_5_steps" in str(e.value)


def test_restore_partial_dict_where_array_is_a_clean_error():
    template = {"params": {"w": np.zeros(3, np.float32)}}
    deeper = {"params": {"w": {"sub": np.zeros(3, np.float32),
                               "sub2": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="tree structure"):
        restore_state_dict_partial(deeper, template, origin="drifted.msgpack")
    flat = {"params": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="flat.msgpack"):
        restore_state_dict_partial(flat, template, origin="flat.msgpack")


def test_restore_partial_mismatched_structure_is_a_clean_error(tmp_path):
    path = _write_ckpt(tmp_path, 5, _make_policy())
    template = _template(_make_policy(hidden=(8, 8, 8)))  # extra layer
    with pytest.raises(ValueError, match="rl_model_5_steps"):
        restore_state_dict_partial(load_checkpoint_raw(path), template,
                                   origin=str(path))


@pytest.mark.parametrize("case", ["ok", "extra", "wider", "deeper_file",
                                  "missing", "f64", "dict_leaf", "flat"])
def test_restore_partial_accepts_and_refuses_as_the_jax_package(case):
    """The same raw trees through both packages' validators: accepted or
    refused alike (extra keys of the file are ignored at every level, as
    flax's restore takes the template's keys)."""
    from marl_distributedformation_tpu.utils.checkpoint import (
        restore_state_dict_partial as jax_restore,
    )

    w = np.ones((2, 3), np.float32)
    template = {"params": {"a": {"kernel": np.zeros((2, 3), np.float32)},
                           "b": np.zeros(3, np.float32)}, "n": 0}
    raw = {
        "ok": {"params": {"a": {"kernel": w}, "b": w[0]}, "n": 3},
        "extra": {"params": {"a": {"kernel": w, "bias": w[0]}, "b": w[0],
                             "c": w}, "n": 3, "other": 1},
        "wider": {"params": {"a": {"kernel": np.ones((2, 4), np.float32)},
                             "b": w[0]}},
        "deeper_file": {"params": {"a": {"kernel": w}, "b": w[0],
                                   "a2": {"kernel": w}}},
        "missing": {"params": {"a": {"kernel": w}}},
        "f64": {"params": {"a": {"kernel": w.astype(np.float64)},
                           "b": w[0]}},
        "dict_leaf": {"params": {"a": {"kernel": w}, "b": {"x": w[0]}}},
        "flat": {"params": w},
    }[case]
    try:
        want = jax_restore(raw, template, origin="f")
    except ValueError:
        with pytest.raises(ValueError, match="checkpoint f"):
            restore_state_dict_partial(raw, template, origin="f")
        return
    got = restore_state_dict_partial(raw, template, origin="f")
    assert jax.tree_util.tree_structure(got) == (
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want)))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Client retry behavior
# ---------------------------------------------------------------------------


def test_backoff_is_capped_exponential_with_retry_after_floor():
    assert backoff_s(0, retry_after_s=0.5, base_s=0.05) == 0.5
    assert backoff_s(5, retry_after_s=3.0, base_s=0.05, cap_s=2.0) == 3.0
    assert backoff_s(0, retry_after_s=0.01, base_s=0.05) == 0.05
    assert backoff_s(1, retry_after_s=0.01, base_s=0.05) == 0.1
    assert backoff_s(2, retry_after_s=0.01, base_s=0.05) == 0.2
    assert backoff_s(10, retry_after_s=0.01, base_s=0.05, cap_s=2.0) == 2.0


def test_backoff_full_jitter_spreads_the_stampede():
    rng = random.Random(1234)
    cap = 2.0
    samples = [
        backoff_s(10, retry_after_s=0.01, base_s=0.05, cap_s=cap,
                  jitter=rng.random)
        for _ in range(500)
    ]
    assert all(0.01 <= s <= cap for s in samples)
    assert len(set(samples)) > 400
    assert min(samples) < 0.2 and max(samples) > 1.8
    assert 0.8 < sum(samples) / len(samples) < 1.2
    assert backoff_s(
        0, retry_after_s=3.0, base_s=0.05, cap_s=2.0, jitter=rng.random
    ) == 3.0
    client = ServingClient(object(), jitter=True, rng=random.Random(7))
    assert client.jitter and client._rng.random() == random.Random(
        7).random()


def test_client_retries_through_backpressure_and_succeeds():
    engine = _slow_engine(
        BucketedPolicyEngine(_make_policy(), buckets=(8,)), 0.15
    )
    with MicroBatchScheduler(engine, max_queue=1, window_ms=0.0) as sched:
        client = ServingClient(
            sched, max_retries=8, backoff_base_s=0.02, backoff_cap_s=0.5
        )
        blockers = [sched.submit(_obs(1, seed=0))]
        try:
            blockers.append(sched.submit(_obs(1, seed=1)))
        except BackpressureError:
            pass
        actions, _ = client.predict(_obs(2, seed=2))
        assert actions.shape == (2, 2)
        assert sched.metrics.rejected_total >= 1, (
            "the retry path was never exercised"
        )
        for f in blockers:
            assert f.result(timeout=30).actions.shape == (1, 2)


class _StubTarget:
    default_timeout_s = 1.0

    def __init__(self):
        self.calls = 0
        self.trace_ids = []

    def submit(self, obs, deterministic=True, timeout_s=None,
               trace_id=None, slo_class="interactive"):
        self.calls += 1
        self.trace_ids.append(trace_id)
        future = Future()
        if self.calls == 1:
            future.set_exception(BackpressureError(0.01))
        else:
            future.set_result(ServedResult(
                actions=np.zeros((1, 2), np.float32), model_step=5,
                latency_s=0.0,
            ))
        return future


def test_client_retries_backpressure_delivered_through_the_future():
    stub = _StubTarget()
    client = ServingClient(stub, max_retries=2, backoff_base_s=0.001)
    result = client.predict_full(np.zeros((1, OBS_DIM), np.float32))
    assert result.model_step == 5
    assert stub.calls == 2, "the future-delivered reject must be retried"
    assert stub.trace_ids[0] is not None
    assert stub.trace_ids == [stub.trace_ids[0]] * 2
    stub2 = _StubTarget()
    with pytest.raises(BackpressureError):
        ServingClient(stub2, max_retries=0).predict_full(
            np.zeros((1, OBS_DIM), np.float32)
        )


def test_client_with_no_retries_surfaces_the_reject():
    engine = _slow_engine(
        BucketedPolicyEngine(_make_policy(), buckets=(8,)), 0.3
    )
    with MicroBatchScheduler(engine, max_queue=1, window_ms=0.0) as sched:
        client = ServingClient(sched, max_retries=0)
        futures = [sched.submit(_obs(1, seed=0))]
        deadline = time.time() + 5.0
        while sched.queue_depth > 0 and time.time() < deadline:
            time.sleep(0.001)
        assert sched.queue_depth == 0, "worker never picked up request 0"
        futures.append(sched.submit(_obs(1, seed=1)))
        with pytest.raises(BackpressureError):
            client.predict(_obs(1, seed=2))
        for f in futures:
            assert f.result(timeout=30).actions.shape == (1, 2)


@pytest.mark.parametrize("endpoints", ["http://localhost:1",
                                       ["http://localhost:1"]])
def test_client_refuses_http_endpoints_naming_a13(endpoints):
    """Endpoints were refused until the fleet frontend was ported: they
    select HTTP mode now (``tests/test_torch_fleet.py`` drives it), and a
    frontend nobody answers at fails as a connection error after the
    retry budget."""
    client = ServingClient(endpoints, max_retries=1, backoff_base_s=0.001)
    with pytest.raises(ConnectionError, match="unreachable"):
        client.predict(_obs(1))


# ---------------------------------------------------------------------------
# Smoke benchmark + CLI
# ---------------------------------------------------------------------------


def test_smoke_benchmark_reports_occupancy_and_latency():
    engine = BucketedPolicyEngine(_make_policy(), buckets=(1, 8, 64))
    with MicroBatchScheduler(engine, window_ms=2.0) as sched:
        report = run_smoke_benchmark(
            sched, row_shape=(OBS_DIM,), sizes=(1, 5, 40),
            duration_s=0.5, num_clients=3,
        )
    assert report["client_requests_ok"] > 0
    assert 0.0 < report["batch_occupancy_pct"] <= 100.0
    assert report["latency_p50_ms"] > 0.0
    assert report["latency_p95_ms"] >= report["latency_p50_ms"]
    for bucket in (1, 8, 64):
        assert report[f"compiles_bucket_{bucket}"] <= 1.0


def test_smoke_benchmark_under_a_scenario():
    engine = BucketedPolicyEngine(_make_policy(), buckets=(1, 8, 64))
    with MicroBatchScheduler(engine, window_ms=2.0) as sched:
        report = run_smoke_benchmark(
            sched, row_shape=(OBS_DIM,), sizes=(1, 5), duration_s=0.2,
            num_clients=2, scenario="sensor_noise", scenario_severity=0.5,
        )
    assert report["client_requests_ok"] > 0
    assert report["scenario"] == "sensor_noise"
    assert report["scenario_severity"] == 0.5


def test_serve_policy_cli_smoke(tmp_path):
    _write_ckpt(tmp_path, 30, _make_policy())
    out = subprocess.run(
        [sys.executable, "-m", "marl_distributedformation_tpu_torch.serve",
         str(tmp_path), "--smoke", "--duration", "0.5", "--clients", "2",
         "--buckets", "1,8,64", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PATH": "/usr/local/bin:/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["client_requests_ok"] > 0
    assert report["batch_occupancy_pct"] > 0.0
    assert report["model_step"] == 30.0
    assert report["buckets"] == "1,8,64"
    assert report["device"] == "cpu"
    assert (tmp_path / "serving" / "metrics.jsonl").exists()


def test_serve_cli_init_policy_smoke_in_process(capsys):
    rc = serve_cli.main(["--init-policy", "MLPActorCritic", "--obs-dim", "8",
                         "--smoke", "--duration", "0.3", "--clients", "2",
                         "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["client_requests_ok"] > 0
    assert report["compiles_bucket_512"] <= 1.0


def test_serve_cli_needs_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--init-policy", "MLPActorCritic", "--obs-dim", "8",
                        "--smoke"])


@pytest.mark.parametrize("argv", [
    # The first and fourth cases were --fleet, --replicas and --port until
    # the fleet was ported (test_serve_cli_serves_a_fleet below).
    ["--slo-iterations", "3"], ["--slo-passes", "2"],
    ["--tenants", "a=logs/a"], ["--big-rung", "64"], ["--sharded"],
    ["--bf16"], ["--mesh-devices", "2"], ["--slo-bench"],
    ["--elastic-bench"], ["--record-trace", "t.jsonl"],
    ["--slo-p95-ms", "20"], ["--load-rps", "10"],
])
def test_serve_cli_refuses_unported_flags_naming_a13(argv):
    with pytest.raises(SystemExit, match="ROADMAP A13"):
        serve_cli.main(["--init-policy", "MLPActorCritic", "--obs-dim", "8",
                        "--smoke", "--device", "cpu", *argv])


def test_serve_cli_serves_a_fleet(tmp_path, capsys):
    """``--fleet --replicas 2``: the fleet smoke's JSON line over two
    replicas on the CPU, one build a rung a replica; ``--port`` and
    ``--replicas`` need ``--fleet``."""
    _write_ckpt(tmp_path, 7, _make_policy())
    rc = serve_cli.main([str(tmp_path), "--fleet", "--replicas", "2",
                         "--buckets", "1,8", "--duration", "0.3",
                         "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["replicas"] == 2.0 and report["client_requests_ok"] > 0
    assert report["max_compiles_per_rung"] == 1.0
    assert report["model_step_max"] == 7.0
    for argv in (["--port", "0"], ["--replicas", "2"]):
        with pytest.raises(SystemExit, match="require --fleet"):
            serve_cli.main([str(tmp_path), "--device", "cpu", *argv])


def test_serve_cli_refuses_a_per_formation_policy_without_its_row(tmp_path):
    """``_infer_row_shape``'s refusal: a CTDE checkpoint serves whole
    formations, so --obs-dim and --agents must size the row."""
    model = CTDEActorCritic(OBS_DIM, hidden=HIDDEN,
                            generator=torch.Generator().manual_seed(0))
    _write_ckpt(tmp_path, 4, LoadedPolicy(model))
    with pytest.raises(SystemExit, match="--obs-dim AND --agents"):
        serve_cli.main([str(tmp_path), "--smoke", "--device", "cpu"])
    rc = serve_cli.main([str(tmp_path), "--smoke", "--device", "cpu",
                         "--obs-dim", str(OBS_DIM), "--agents", "3",
                         "--duration", "0.2", "--clients", "1"])
    assert rc == 0


def test_serve_cli_serves_a_gnn_run_through_its_config(tmp_path, capsys):
    """A GNN checkpoint reads its k from the run's ``config.json``."""
    cfg = load_config(["policy=gnn", "obs_mode=knn", f"knn_k={K}",
                       f"num_agents_per_formation={N_AGENTS}"])
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    model = GNNActorCritic(k=K, generator=torch.Generator().manual_seed(0))
    _write_ckpt(tmp_path, 9, LoadedPolicy(model))
    with pytest.raises(SystemExit, match="--obs-dim AND --agents"):
        serve_cli.main([str(tmp_path), "--smoke", "--device", "cpu"])
    rc = serve_cli.main([str(tmp_path), "--smoke", "--device", "cpu",
                         "--obs-dim", str(GNN_OBS_DIM), "--agents",
                         str(N_AGENTS), "--duration", "0.2", "--clients",
                         "1", "--buckets", "1,8"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["model_step"] == 9.0 and report["client_requests_ok"] > 0


def test_serve_cli_fails_when_the_smoke_served_nothing(tmp_path, capsys):
    _write_ckpt(tmp_path, 3, _make_policy())
    rc = serve_cli.main([str(tmp_path), "--smoke", "--device", "cpu",
                         "--obs-dim", str(OBS_DIM + 1), "--duration", "0.2",
                         "--clients", "1"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["client_requests_ok"] == 0.0


def test_serve_cli_refusals_of_arguments():
    with pytest.raises(SystemExit, match="need a log_dir or --init-policy"):
        serve_cli.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="requires --obs-dim"):
        serve_cli.main(["--init-policy", "MLPActorCritic", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown scenario|storm"):
        serve_cli.main(["--init-policy", "MLPActorCritic", "--obs-dim", "8",
                        "--scenario", "stormm", "--device", "cpu"])
