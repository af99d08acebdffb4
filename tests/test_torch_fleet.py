"""The port's serving fleet (``serving/fleet/``), its HTTP client and
``CheckpointDiscovery`` on the CPU, held against the JAX package.

The same checkpoints and rows go through JAX's fleet (two replicas on two
of conftest's eight CPU devices) and the port's (two replicas on the CPU
device): deterministic actions agree within ``rtol=1e-5, atol=1e-6`` (the
two frameworks sum the matmuls in different orders) and the ``model_step``
sequence through a coordinated swap is equal. The behaviours of JAX's
``tests/test_fleet.py`` are the port's own tests here, bounded on counts
and invariants rather than on timing under load; the frontend's status
codes equal JAX's for the same failure cases, and ``CheckpointDiscovery``
answers as JAX's over the same sequence of files.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
)
from marl_distributedformation_tpu.serving.fleet import (
    FleetFrontend as JaxFrontend,
    FleetRouter as JaxRouter,
    fleet_from_checkpoint_dir as jax_fleet_from_checkpoint_dir,
    warmup_fleet as jax_warmup_fleet,
)
from marl_distributedformation_tpu.utils.checkpoint import (
    CheckpointDiscovery as JaxDiscovery,
)
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    Tracer,
    set_registry,
    set_tracer,
)
from marl_distributedformation_tpu_torch.serving import (
    BackpressureError,
    ServingClient,
)
from marl_distributedformation_tpu_torch.serving.fleet import (
    FleetFrontend,
    FleetReloadCoordinator,
    FleetRouter,
    NoHealthyReplicas,
    fleet_from_checkpoint_dir,
    run_fleet_smoke,
    warmup_fleet,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CheckpointDiscovery,
    save_checkpoint,
)

OBS_DIM = 8
HIDDEN = (8, 8)
BUCKETS = (1, 8)
RTOL, ATOL = 1e-5, 1e-6
CPU = ["cpu"]


@pytest.fixture(autouse=True)
def private_planes():
    """A fresh metrics registry and tracer a test: fleet snapshots record
    gauges and circuit breaks record incidents process-wide."""
    registry, tracer = set_registry(MetricsRegistry()), set_tracer(Tracer())
    yield
    set_registry(registry)
    set_tracer(tracer)


def _make_policy(seed=0, hidden=HIDDEN):
    model = MLPActorCritic(OBS_DIM, act_dim=2, hidden=hidden,
                           generator=torch.Generator().manual_seed(seed))
    return LoadedPolicy(model.eval())


def _write_ckpt(log_dir, step, policy):
    name = type(policy.model).__name__
    return save_checkpoint(
        log_dir, step,
        {"policy": name, "params": params_to_jax(policy.params, name),
         "num_timesteps": step},
    )


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


def _router(policy=None, **kwargs):
    kwargs.setdefault("num_replicas", 2)
    kwargs.setdefault("buckets", BUCKETS)
    return FleetRouter(policy or _make_policy(), devices=CPU, **kwargs)


def _slow(engine, delay_s):
    """Delay ``engine.act`` after warm-up, so queues build."""
    orig = engine.act

    def slow_act(*args, **kwargs):
        time.sleep(delay_s)
        return orig(*args, **kwargs)

    engine.act = slow_act


def _wait_for(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def test_fleet_matches_jax_through_a_coordinated_swap(tmp_path):
    """Both fleets from one checkpoint directory: replica-by-replica
    actions within tolerance, and a swap to a newer checkpoint gives both
    the same ``model_step`` sequence, every replica (the dead one too) on
    the new step."""
    watch = tmp_path / "watch"
    a, b = _make_policy(seed=0), _make_policy(seed=7)
    _write_ckpt(watch, 100, a)
    router, coordinator = fleet_from_checkpoint_dir(
        watch, device="cpu", num_replicas=2, buckets=BUCKETS)
    jrouter, jcoordinator = jax_fleet_from_checkpoint_dir(
        watch, num_replicas=2, buckets=BUCKETS,
        devices=jax.local_devices()[:2])
    warmup_fleet(router, (OBS_DIM,))
    jax_warmup_fleet(jrouter, (OBS_DIM,))
    rows = _obs(5, seed=3)
    steps, jsteps = [], []
    with router, jrouter:
        for phase in range(2):
            for i in range(2):
                got = router.replicas[i].scheduler.submit(rows).result(30)
                want = jrouter.replicas[i].scheduler.submit(rows).result(30)
                np.testing.assert_allclose(
                    got.actions, np.asarray(want.actions),
                    rtol=RTOL, atol=ATOL)
                steps.append(got.model_step)
                jsteps.append(want.model_step)
            ref = (a if phase == 0 else b).predict(rows)[0]
            np.testing.assert_allclose(got.actions, ref, rtol=RTOL,
                                       atol=ATOL)
            if phase == 0:
                router.kill_replica(1)
                jrouter.kill_replica(1)
                router.replicas[1].scheduler.start()
                jrouter.replicas[1].scheduler.start()
                _write_ckpt(watch, 200, b)
                assert coordinator.refresh() and jcoordinator.refresh()
    assert steps == jsteps == [100, 100, 200, 200]
    assert coordinator.fleet_step == jcoordinator.fleet_step == 200
    assert [r.registry.swap_count for r in router.replicas] == [1, 1]
    # Each registry holds its own copy: no replica aliases the policy's
    # parameters or another replica's.
    ptrs = {t.data_ptr() for r in router.replicas
            for t in r.registry.active()[0].values()}
    ptrs |= {t.data_ptr() for t in router.policy.params.values()}
    assert len(ptrs) == 3 * len(router.policy.params)


def test_frontend_status_codes_equal_jax(tmp_path):
    """The same failure cases through both frontends: malformed JSON,
    an unknown path, backpressure from a full one-replica fleet (429 and
    its Retry-After), health and act with every replica broken."""

    def codes(router, frontend_cls, slow_obs):
        warm = warmup_fleet if isinstance(router, FleetRouter) \
            else jax_warmup_fleet
        warm(router, (OBS_DIM,))
        _slow(router.replicas[0].engine, 0.3)
        out = []
        with router, frontend_cls(router, port=0) as frontend:
            url = frontend.url
            for request in (
                urllib.request.Request(url + "/v1/act", data=b"not json"),
                urllib.request.Request(url + "/nope"),
            ):
                out.append(_status(request))
            in_flight = router.submit(slow_obs(0))
            assert _wait_for(
                lambda: router.replicas[0].scheduler.queue_depth == 0)
            queued = router.submit(slow_obs(1))
            status, headers, body = _status_full(_act_request(
                url, {"obs": slow_obs(2).tolist()}))
            out.append(status)
            out.append(int(headers["Retry-After"]) >= 1
                       and body["retry_after_s"] > 0
                       and headers["X-Trace-Id"] == body["trace_id"])
            for fut in (in_flight, queued):
                fut.result(timeout=30)
            router._break(router.replicas[0], "test")
            out.append(_status(urllib.request.Request(url + "/v1/health")))
            out.append(_status(_act_request(
                url, {"obs": slow_obs(3).tolist()})))
        return out

    policy = _make_policy()
    jax_policy = JaxLoadedPolicy(
        {"params": params_to_jax(policy.params,
                                 "MLPActorCritic")["params"]},
        model_kwargs={"hidden": HIDDEN})
    kw = dict(num_replicas=1, buckets=(1,), window_ms=0.0, max_queue=1,
              probe_interval_s=60.0)
    port = codes(FleetRouter(policy, devices=CPU, **kw), FleetFrontend,
                 lambda s: _obs(1, seed=s))
    ref = codes(JaxRouter(jax_policy, devices=jax.local_devices()[:1], **kw),
                JaxFrontend, lambda s: _obs(1, seed=s))
    assert port == ref == [400, 404, 429, True, 503, 503]


def _act_request(url, payload, headers=None):
    return urllib.request.Request(
        url + "/v1/act", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})


def _status_full(request):
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read() or b"{}")


def _status(request):
    return _status_full(request)[0]


@pytest.mark.parametrize("steps", [
    [10, 30, 20],  # out of order
    [5, 5, 7],  # the same step twice (a second name)
])
def test_checkpoint_discovery_matches_jax(tmp_path, steps):
    """The same sequence of files through both discoveries, torn ``.tmp``
    files, quarantined files and a deleted newest file included:
    ``latest()`` and ``poll_new()`` answer alike at every stage."""
    ours, theirs = CheckpointDiscovery(tmp_path), JaxDiscovery(tmp_path)
    ours_late = CheckpointDiscovery(tmp_path, start_after_step=8)
    theirs_late = JaxDiscovery(tmp_path, start_after_step=8)

    def same():
        assert ours.latest() == theirs.latest()
        assert ours.poll_new() == theirs.poll_new()
        assert ours_late.poll_new() == theirs_late.poll_new()

    same()  # an empty directory
    policy = _make_policy()
    for i, step in enumerate(steps):
        path = _write_ckpt(tmp_path, step, policy)
        if i == 1 and steps[1] == steps[0]:
            os.replace(path, tmp_path / f"run_b_rl_model_{step}_steps.msgpack")
        same()
    (tmp_path / ".rl_model_90_steps.msgpack.tmp").write_bytes(b"torn")
    (tmp_path / "rl_model_80_steps.msgpack.quarantined").write_bytes(b"x")
    same()
    newest = max(steps)
    for p in tmp_path.glob(f"*rl_model_{newest}_steps.msgpack"):
        p.unlink()
    same()


# ---------------------------------------------------------------------------
# Routing, circuit breaking, backpressure
# ---------------------------------------------------------------------------


def test_router_routes_around_a_slow_replica():
    router = _router(window_ms=0.0)
    warmup_fleet(router, (OBS_DIM,))
    with router:
        for r in router.replicas:  # one batch each: a measured batch time
            r.scheduler.submit(_obs(1)).result(timeout=30)
        _slow(router.replicas[0].engine, 0.1)
        futures = []
        for i in range(30):
            futures.append(router.submit(_obs(2, seed=i)))
            time.sleep(0.003)
        results = [f.result(timeout=30) for f in futures]
    assert all(r.actions.shape == (2, 2) for r in results)
    served = router.metrics.routed_per_replica()
    assert served.get(1, 0) > 2 * max(1, served.get(0, 0)), served


def test_replica_kill_loses_no_accepted_requests():
    policy = _make_policy()
    router = _router(policy, window_ms=0.0, probe_interval_s=0.02,
                     max_failovers=2)
    warmup_fleet(router, (OBS_DIM,))
    _slow(router.replicas[0].engine, 0.05)
    ref, _ = policy.predict(_obs(2, seed=1), deterministic=True)
    with router:
        router._break(router.replicas[1], "test quarantine")
        first = router.submit(_obs(2, seed=1))
        assert _wait_for(lambda: router.replicas[0].scheduler._busy)
        queued = [router.submit(_obs(2, seed=1)) for _ in range(5)]
        assert router.replicas[0].scheduler.queue_depth > 0
        router.kill_replica(0)
        for fut in [first] + queued:
            np.testing.assert_allclose(fut.result(timeout=30).actions, ref,
                                       rtol=RTOL, atol=ATOL)
        assert not router.replicas[0].healthy
        assert router.metrics.failed_over_total >= len(queued)
        assert router.healthy_replicas == 1
        res = router.submit(_obs(3, seed=2)).result(timeout=30)
        assert res.actions.shape == (3, 2) and res.replica == 1


def test_all_replicas_broken_raises_no_healthy():
    router = _router(buckets=(1,), probe_interval_s=60.0)
    with router:
        router.kill_replica(0)
        router.kill_replica(1)
        with pytest.raises(NoHealthyReplicas):
            router.submit(_obs(1))


def test_fleet_backpressure_carries_the_smallest_retry_after():
    router = _router(window_ms=0.0, max_queue=1)
    warmup_fleet(router, (OBS_DIM,))
    for r in router.replicas:
        _slow(r.engine, 0.1)
    with router:
        accepted, rejected = [], None
        for i in range(12):
            try:
                accepted.append(router.submit(_obs(1, seed=i)))
            except BackpressureError as e:
                rejected = e
                break
        assert rejected is not None, "fleet queue bound never engaged"
        quotes = [r.scheduler.retry_after_s() for r in router.replicas]
        assert 0.0 < rejected.retry_after_s
        assert rejected.retry_after_s <= max(quotes) + 1e-9
        assert router.metrics.rejected_total >= 1
        for f in accepted:
            assert f.result(timeout=30).actions.shape == (1, 2)


def test_a_rung_captured_during_traffic_breaks_its_replica():
    """Budget 1 a rung: a rebuild during traffic (here a dropped rung)
    raises ``RetraceError``, the router breaks that replica and fails the
    request over."""
    router = _router(window_ms=0.0, probe_interval_s=60.0)
    warmup_fleet(router, (OBS_DIM,))
    engine = router.replicas[0].engine
    engine._rungs.clear()  # the next dispatch of rung 1 builds it again
    with router:  # idle replicas tie: replica 0 is routed first
        res = router.submit(_obs(1), timeout_s=5.0).result(timeout=30)
    assert res.replica == 1
    assert not router.replicas[0].healthy
    assert "RetraceError" in router.replicas[0].break_reason
    assert engine.compile_counts()[1] == 2  # the refused rebuild counted


# ---------------------------------------------------------------------------
# The coordinated reload
# ---------------------------------------------------------------------------


def test_coordinated_swap_mid_storm_is_step_monotonic(tmp_path):
    watch, stage = tmp_path / "watch", tmp_path / "stage"
    _write_ckpt(watch, 100, _make_policy(seed=0))
    staged = _write_ckpt(stage, 200, _make_policy(seed=7))
    router, coordinator = fleet_from_checkpoint_dir(
        watch, device="cpu", num_replicas=2, buckets=BUCKETS,
        window_ms=1.0, probe_interval_s=0.05)

    def chaos():
        router.kill_replica(0)
        os.replace(staged, watch / staged.name)
        assert coordinator.refresh()
        router.replicas[0].scheduler.start()

    log = {}
    with router:
        report = run_fleet_smoke(
            router, (OBS_DIM,), duration_s=0.6, num_clients=3,
            coordinator=coordinator, mid_storm=chaos, mid_storm_at_s=0.2,
            log=log)
    from marl_distributedformation_tpu_torch.chaos import (
        check_budget_one,
        check_no_request_lost,
        check_step_monotonic,
    )

    assert report["client_requests_ok"] > 0
    assert report["client_failed"] == 0.0, report
    assert report["step_monotonic_violations"] == 0.0
    assert report["model_step_min"] == 100.0
    assert report["model_step_max"] == 200.0
    assert report["max_compiles_per_rung"] <= 1.0
    assert report["fleet_swap_count"] == 1.0
    assert check_step_monotonic(log["steps"]) == []
    assert check_no_request_lost(log["outcomes"]) == []
    assert len(log["outcomes"]) >= report["client_requests_ok"]
    assert check_budget_one({
        f"replica{i}_rung{b}": n
        for i, counts in router.compile_counts().items()
        for b, n in counts.items()}) == []
    assert all(r.registry.active_step == 200 for r in router.replicas)
    assert coordinator.last_pause_ms >= 0.0


def test_coordinator_polls_once_and_contains_bad_checkpoints(tmp_path):
    _write_ckpt(tmp_path, 10, _make_policy(hidden=(8, 8)))
    router, coordinator = fleet_from_checkpoint_dir(
        tmp_path, device="cpu", num_replicas=2, buckets=(1,))
    _write_ckpt(tmp_path, 20, _make_policy(hidden=(16, 16)))
    assert not coordinator.refresh()
    assert len(coordinator.load_errors) == 1
    assert "rl_model_20_steps" in coordinator.load_errors[0][0]
    assert all(r.registry.active_step == 10 for r in router.replicas)
    _write_ckpt(tmp_path, 30, _make_policy(seed=3))
    assert coordinator.refresh()
    assert coordinator.fleet_step == 30
    assert all(r.registry.active_step == 30 for r in router.replicas)
    _write_ckpt(tmp_path, 25, _make_policy(seed=4))
    assert not coordinator.refresh()
    assert coordinator.fleet_step == 30


def test_coordinator_commit_aborts_cleanly_on_a_wedged_replica(tmp_path):
    _write_ckpt(tmp_path, 10, _make_policy(seed=0))
    router, coordinator = fleet_from_checkpoint_dir(
        tmp_path, device="cpu", num_replicas=2, buckets=BUCKETS,
        probe_interval_s=60.0)
    coordinator.commit_timeout_s = 0.05
    warmup_fleet(router, (OBS_DIM,))
    _write_ckpt(tmp_path, 20, _make_policy(seed=1))
    wedged = router.replicas[1].registry.batch_lock
    wedged.acquire()  # a worker stuck inside a dispatch
    try:
        with router:
            assert not coordinator.refresh()
            assert coordinator.fleet_step == 10
            assert all(r.registry.active_step == 10 for r in router.replicas)
            assert "commit aborted" in coordinator.load_errors[-1][1]
            # The gates reopened: the rest of the fleet keeps serving.
            assert all(r.registry.batch_lock._open.is_set()
                       for r in router.replicas)
            router._break(router.replicas[1], "wedged in test")
            res = router.submit(_obs(2, seed=1)).result(timeout=30)
            assert res.model_step == 10 and res.replica == 0
    finally:
        wedged.release()
    assert coordinator.refresh()
    assert all(r.registry.active_step == 20 for r in router.replicas)


def test_coordinator_background_watcher_swaps(tmp_path):
    _write_ckpt(tmp_path, 1, _make_policy(seed=0))
    router, coordinator = fleet_from_checkpoint_dir(
        tmp_path, device="cpu", num_replicas=2, buckets=(1,),
        poll_interval_s=0.02)
    with router, coordinator:
        _write_ckpt(tmp_path, 2, _make_policy(seed=1))
        assert _wait_for(lambda: coordinator.fleet_step == 2)
    assert coordinator.swap_count == 1


def test_two_lanes_each_keep_their_own_monotonic_step(tmp_path):
    """``lanes=``: one engine a replica serves two tenant lanes; a
    lane-keyed coordinator swaps lane ``a`` only, and each lane answers
    with its own parameters and its own step."""
    a0, a1, b0 = (_make_policy(seed=s) for s in (0, 1, 2))
    router = FleetRouter(
        a0, devices=CPU, num_replicas=2, buckets=BUCKETS,
        lanes={"a": (a0.params, 10), "b": (b0.params, 50)})
    coordinator = FleetReloadCoordinator(tmp_path, router, model_id="a")
    warmup_fleet(router, (OBS_DIM,))
    rows = _obs(3, seed=4)
    with router:
        before = {m: router.submit(rows, model_id=m).result(timeout=30)
                  for m in ("a", "b")}
        _write_ckpt(tmp_path, 20, a1)
        assert coordinator.refresh()
        after = {m: router.submit(rows, model_id=m).result(timeout=30)
                 for m in ("a", "b")}
        with pytest.raises(ValueError, match="model_id"):
            router.submit(rows)
    assert [before["a"].model_step, after["a"].model_step] == [10, 20]
    assert [before["b"].model_step, after["b"].model_step] == [50, 50]
    for res, policy in ((before["a"], a0), (after["a"], a1),
                        (before["b"], b0), (after["b"], b0)):
        np.testing.assert_allclose(res.actions, policy.predict(rows)[0],
                                   rtol=RTOL, atol=ATOL)
    assert router.lane_steps() == {"a": 20, "b": 50}


# ---------------------------------------------------------------------------
# Clients and the HTTP frontend
# ---------------------------------------------------------------------------


def test_serving_client_over_the_router_and_over_http():
    policy = _make_policy()
    router = _router(policy, initial_step=42)
    warmup_fleet(router, (OBS_DIM,))
    obs = _obs(3, seed=5)
    ref, _ = policy.predict(obs, deterministic=True)
    with router, FleetFrontend(router, port=0) as frontend:
        direct = ServingClient(router, max_retries=1).predict(obs)
        over_http = ServingClient(frontend.url, max_retries=1).predict(obs)
        listed = ServingClient(["http://127.0.0.1:1", frontend.url],
                               max_retries=2, backoff_base_s=0.001)
        via_failover = listed.predict(obs)
    for actions, step in (direct, over_http, via_failover):
        np.testing.assert_allclose(actions, ref, rtol=RTOL, atol=ATOL)
        assert step == 42
    np.testing.assert_array_equal(over_http[0], direct[0])


def test_http_client_retries_a_429_with_backoff():
    """A one-slot fleet answers 429 to the client's first attempt; the
    client sleeps the backoff floored at the server's hint and lands."""
    router = _router(num_replicas=1, buckets=(1,), window_ms=0.0,
                     max_queue=1)
    warmup_fleet(router, (OBS_DIM,))
    _slow(router.replicas[0].engine, 0.2)
    with router, FleetFrontend(router, port=0) as frontend:
        busy = router.submit(_obs(1, seed=0))
        assert _wait_for(lambda: router.replicas[0].scheduler.queue_depth
                         == 0)
        queued = router.submit(_obs(1, seed=1))
        client = ServingClient(frontend.url, max_retries=5,
                               backoff_base_s=0.01, jitter=False)
        actions, _ = client.predict(_obs(1, seed=2))
        busy.result(timeout=30)
        queued.result(timeout=30)
    assert actions.shape == (1, 2)
    assert router.metrics.rejected_total >= 1


def test_frontend_health_metrics_and_prometheus_text():
    router = _router(initial_step=7)
    warmup_fleet(router, (OBS_DIM,))
    with router, FleetFrontend(router, port=0) as frontend:
        ServingClient(frontend.url).predict(_obs(2))
        health = json.loads(urllib.request.urlopen(
            frontend.url + "/v1/health", timeout=10).read())
        metrics = json.loads(urllib.request.urlopen(
            frontend.url + "/v1/metrics", timeout=10).read())
        with urllib.request.urlopen(urllib.request.Request(
                frontend.url + "/v1/metrics",
                headers={"Accept": "text/plain"}), timeout=10) as resp:
            text = resp.read().decode()
            ctype = resp.headers["Content-Type"]
    assert health == {"healthy_replicas": 2, "replicas": 2, "model_step": 7}
    assert metrics["fleet_routed_total"] >= 1.0
    assert ctype.startswith("text/plain")
    assert "fleet_routed_total" in text


def test_trace_id_reaches_the_batch_span():
    tracer = Tracer(ring_size=1024)
    previous = set_tracer(tracer)
    try:
        router = _router()
        warmup_fleet(router, (OBS_DIM,))
        sent = [f"client-req-{i}" for i in range(6)]
        echoes, errors = {}, []

        def worker(tid):
            try:
                status, headers, body = _status_full(_act_request(
                    frontend.url, {"obs": _obs(2, seed=1).tolist()},
                    headers={"X-Trace-Id": tid}))
                assert status == 200
                echoes[tid] = (body["trace_id"], headers["X-Trace-Id"])
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        with router, FleetFrontend(router, port=0) as frontend:
            threads = [threading.Thread(target=worker, args=(t,))
                       for t in sent]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            _, headers, body = _status_full(_act_request(
                frontend.url, {"obs": _obs(1).tolist()}))
        assert not errors, errors
        assert echoes == {t: (t, t) for t in sent}
        assert body["trace_id"] and headers["X-Trace-Id"] == body["trace_id"]
        linked = [tid for r in tracer.snapshot()
                  if r["kind"] == "span" and r["name"] == "serve.batch"
                  for tid in r["attrs"].get("trace_ids", ())]
        for tid in sent:
            assert linked.count(tid) == 1
    finally:
        set_tracer(previous)


def test_fleet_refuses_the_unported_paths_and_the_missing_gpu(monkeypatch):
    policy = _make_policy()
    with pytest.raises(NotImplementedError, match="A13"):
        FleetRouter(policy, devices=CPU, sharded=object())
    router = _router(policy)
    for call in (lambda: router.build_sharded_replica(None),
                 lambda: router._commit_resplit([], set())):
        with pytest.raises(NotImplementedError, match="A13"):
            call()
    coordinator = FleetReloadCoordinator("unused", router)
    for call in (coordinator.commit_resplit, coordinator.prepare_global,
                 coordinator.commit_prepared, coordinator.abort_prepared):
        with pytest.raises(NotImplementedError, match="A13"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        FleetRouter(policy)
