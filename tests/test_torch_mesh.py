"""The port's cross-host serving tier (``serving/mesh/``) on the CPU, held
against the JAX package's.

JAX's ``tests/test_mesh.py`` case by case, with in-process hosts
(``build_inprocess_host(..., device="cpu")``, real HTTP/RPC between
threads) and one real two-host subprocess mesh; bounded on counts and
invariants, not on timing under load. Held against the JAX package:

- **wire parity** — JAX's ``rpc_call`` against the port's
  ``JsonRpcServer`` and the port's against JAX's: the same replies,
  status codes, bodies and error taxonomy;
- **agent against JAX's coordinator** — a port ``HostAgent`` registers
  and heartbeats with JAX's ``MeshCoordinator``, which drives a global
  swap on it and walks it alive -> suspect -> dead when it falls silent;
- **the same decisions** — fed the same register/heartbeat sequence on a
  patched clock, both coordinators give the same ``hosts()`` at every
  tick; fed the same gossiped drains, both ``MetaRouter``s score and pick
  the same hosts;
- **a global swap on a GNN** — every host of a 2-host mesh answers
  bitwise as the port's single engine on the new checkpoint, and within
  serving's rtol 1e-5, atol 1e-6 of JAX's engine on the same file;
- the two-phase commit (wedged prepare -> abort with every host restored,
  idempotent commit retry, catch-up of a missed commit, the prepare TTL),
  the ``--mesh`` storm at its tiny default (0 violations, JAX's report
  keys plus the port's) and ``always_learning`` with ``mesh_serve=true``.
"""

import http.client
import json
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
)
from marl_distributedformation_tpu.env import EnvParams as JaxEnvParams
from marl_distributedformation_tpu.serving import (
    BucketedPolicyEngine as JaxEngine,
)
from marl_distributedformation_tpu.serving.mesh import (
    MeshCoordinator as JaxCoordinator,
    MetaRouter as JaxMetaRouter,
)
from marl_distributedformation_tpu.serving.mesh import (
    coordinator as jax_coordinator_mod,
)
from marl_distributedformation_tpu.serving.mesh import rpc as jax_rpc
from marl_distributedformation_tpu_torch.chaos import (
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    check_step_monotonic,
    get_fault_plane,
    set_fault_plane,
)
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
from marl_distributedformation_tpu_torch.env import EnvParams
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
)
from marl_distributedformation_tpu_torch.obs import (
    MetricsRegistry,
    Tracer,
    get_tracer,
    set_registry,
    set_tracer,
)
from marl_distributedformation_tpu_torch.serving import (
    BucketedPolicyEngine,
    ServingClient,
)
from marl_distributedformation_tpu_torch.serving.mesh import (
    HOST_ALIVE,
    HOST_DEAD,
    HOST_SUSPECT,
    HostAgent,
    JsonRpcServer,
    MeshCoordinator,
    MeshFrontend,
    MeshRpcError,
    MeshUnreachable,
    MetaRouter,
    NoHealthyHosts,
    build_inprocess_host,
    rpc_call,
    spawn_local_mesh,
)
from marl_distributedformation_tpu_torch.serving.mesh import (
    coordinator as coordinator_mod,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)

OBS_DIM = 6
HIDDEN = (8, 8)
RTOL, ATOL = 1e-5, 1e-6  # serving's tolerance against the JAX engine
JAX_MESH = Path(__file__).resolve().parent.parent / (
    "marl_distributedformation_tpu/serving/mesh/__init__.py")


@pytest.fixture(autouse=True)
def private_planes():
    """A fresh metrics registry, tracer and fault plane a test."""
    previous = (set_registry(MetricsRegistry()), set_tracer(Tracer()),
                set_fault_plane(FaultPlane()))
    yield
    get_fault_plane().enabled = False
    set_registry(previous[0])
    set_tracer(previous[1])
    set_fault_plane(previous[2])


def _make_model(seed=0):
    return MLPActorCritic(OBS_DIM, act_dim=2, hidden=HIDDEN,
                          generator=torch.Generator().manual_seed(seed))


def _write_ckpt(log_dir, step, model):
    name = type(model).__name__
    return save_checkpoint(
        Path(log_dir), step,
        {"policy": name, "params": params_to_jax(model.state_dict(), name),
         "num_timesteps": step},
    )


def _obs(n=1, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


def _register(url_or_coord, host_id, step=100):
    payload = {"host_id": host_id, "control_url": "http://127.0.0.1:1",
               "data_url": "http://127.0.0.1:2", "step": step}
    if isinstance(url_or_coord, str):
        return rpc_call(url_or_coord, "mesh.register", payload)
    return url_or_coord._rpc_register(payload)


def _stop_stacks(stacks):
    for router, _, frontend, agent in stacks:
        agent.stop()
        frontend.stop()
        router.stop()


# ---------------------------------------------------------------------------
# RPC substrate and wire parity
# ---------------------------------------------------------------------------

HANDLERS = {
    "echo": lambda p: {"got": p},
    "boom": lambda p: (_ for _ in ()).throw(KeyError("nope")),
    "none": lambda p: None,
}


def test_rpc_roundtrip_and_error_taxonomy():
    """JAX's: 200 -> payload, handler exception -> typed MeshRpcError (its
    type, no traceback), unknown method -> 404, nobody listening ->
    MeshUnreachable."""
    server = JsonRpcServer(HANDLERS).start()
    try:
        assert rpc_call(server.url, "echo", {"x": 1}) == {"got": {"x": 1}}
        with pytest.raises(MeshRpcError) as err:
            rpc_call(server.url, "boom", {})
        assert err.value.status == 500
        assert err.value.error_type == "KeyError"
        with pytest.raises(MeshRpcError) as err:
            rpc_call(server.url, "nosuch", {})
        assert err.value.status == 404
        dead_port = server.port
    finally:
        server.stop()
    with pytest.raises(MeshUnreachable):
        rpc_call(f"http://127.0.0.1:{dead_port}", "echo", {}, timeout_s=1.0)


def _raw(url, method, path, body=b"", headers=None):
    """``(status, body bytes)`` of one raw request."""
    parsed = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=5.0)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _outcome(call):
    try:
        return ("ok", call())
    except MeshRpcError as e:  # the port's taxonomy
        return (type(e).__name__, e.status, e.error_type, e.detail)
    except jax_rpc.MeshRpcError as e:  # the JAX package's
        return (type(e).__name__, e.status, e.error_type, e.detail)


@pytest.mark.parametrize("client", ["jax", "port"])
def test_wire_parity_with_jax(client):
    """One package's ``rpc_call`` against the other's server, and the same
    raw requests against both servers: equal replies, status codes,
    bodies and error taxonomy, both ways."""
    servers = {"port": JsonRpcServer(HANDLERS).start(),
               "jax": jax_rpc.JsonRpcServer(HANDLERS).start()}
    other = "port" if client == "jax" else "jax"
    call = jax_rpc.rpc_call if client == "jax" else rpc_call
    try:
        for method, payload in (("echo", {"x": [1, 2.5, "a"]}),
                                ("none", {}), ("boom", {}), ("nosuch", {})):
            got = _outcome(lambda: call(servers[other].url, method,
                                        payload))
            want = _outcome(lambda: call(servers[client].url, method,
                                         payload))
            assert got == want, (method, got, want)
        for request in (("POST", "/rpc/echo", b'{"y": 3}'),
                        ("POST", "/rpc/boom", b"{}"),
                        ("POST", "/rpc/nosuch", b"{}"),
                        ("POST", "/rpc/echo", b"{not json"),
                        ("POST", "/elsewhere", b"{}")):
            headers = {"Content-Type": "application/json"}
            assert (_raw(servers["port"].url, *request, headers=headers)
                    == _raw(servers["jax"].url, *request, headers=headers))
        dead = servers[other].port
    finally:
        for s in servers.values():
            s.stop()
    got = _outcome(lambda: call(f"http://127.0.0.1:{dead}", "echo", {},
                                timeout_s=1.0))
    assert got[0] == "MeshUnreachable" and got[1] == 500


# ---------------------------------------------------------------------------
# Gossip: lease taxonomy, quarantine, the same decisions as JAX
# ---------------------------------------------------------------------------


def test_gossip_suspect_to_dead_timing_and_revival():
    coord = MeshCoordinator(lease_s=0.25, dead_after_s=0.25).serve()
    try:
        reply = _register(coord.url, "h0")
        assert reply["registered"] and reply["lease_s"] == 0.25

        def state():
            return coord.hosts()[0]["state"]

        assert state() == HOST_ALIVE
        deadline = time.monotonic() + 5.0
        while state() == HOST_ALIVE and time.monotonic() < deadline:
            time.sleep(0.02)
        assert state() == HOST_SUSPECT
        while state() == HOST_SUSPECT and time.monotonic() < deadline:
            time.sleep(0.02)
        assert state() == HOST_DEAD
        assert coord.routable_hosts() == []
        reply = rpc_call(coord.url, "mesh.heartbeat",
                         {"host_id": "h0", "step": 100})
        assert reply["registered"] and state() == HOST_ALIVE
        assert rpc_call(coord.url, "mesh.heartbeat",
                        {"host_id": "ghost"}) == {"registered": False}
    finally:
        coord.stop()


def test_sweep_emits_death_incident_outside_hosts_lock():
    coord = MeshCoordinator(lease_s=0.01, dead_after_s=0.01)
    _register(coord, "h0")
    time.sleep(0.05)
    tracer = get_tracer()
    lock_states = []
    original = tracer.incident

    def spy(name, **fields):
        if name == "mesh_host_dead":
            lock_states.append(coord._hosts_lock.locked())
        return original(name, **fields)

    tracer.incident = spy
    try:
        coord.sweep()
    finally:
        tracer.incident = original
    assert lock_states == [False]
    assert "lease expired" in coord.hosts()[0]["dead_reason"]


def test_stale_host_quarantined_until_caught_up():
    coord = MeshCoordinator(lease_s=5.0, dead_after_s=5.0).serve()
    try:
        _register(coord.url, "h0")
        assert [h.host_id for h in coord.routable_hosts()] == ["h0"]
        coord._mesh_step = 200
        assert coord.routable_hosts() == []
        reply = rpc_call(coord.url, "mesh.heartbeat",
                         {"host_id": "h0", "step": 200})
        assert reply["mesh_step"] == 200
        assert [h.host_id for h in coord.routable_hosts()] == ["h0"]
    finally:
        coord.stop()


class _Clock:
    """A patched ``time`` module: ``monotonic`` is the test's."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return time.perf_counter()


def _view(coord):
    return (sorted(coord.hosts(), key=lambda h: h["host_id"]),
            sorted(h.host_id for h in coord.routable_hosts()),
            sorted(h.host_id for h in coord.barrier_hosts()),
            coord.fleet_step)


def test_coordinator_decisions_equal_jax_on_a_patched_clock(monkeypatch):
    """The same registrations, heartbeats, sweeps, out-of-band deaths and
    a step the mesh moved past, on one patched clock: both coordinators
    hold the same view at every tick."""
    clock = _Clock()
    monkeypatch.setattr(coordinator_mod, "time", clock)
    monkeypatch.setattr(jax_coordinator_mod, "time", clock)
    coords = [MeshCoordinator(lease_s=1.0, dead_after_s=2.0),
              JaxCoordinator(lease_s=1.0, dead_after_s=2.0)]

    def both(fn):
        out = [fn(c) for c in coords]
        assert out[0] == out[1]
        return out[0]

    both(lambda c: _register(c, "h0", step=100))
    clock.t += 0.3
    both(lambda c: _register(c, "h1", step=120))
    script = [
        # (dt, heartbeats (host, step), mark_dead host, mesh step)
        (0.5, [("h0", 100)], None, None),
        (0.6, [("h0", 100), ("h1", 120)], None, None),
        (0.9, [], None, None),
        (0.5, [("h0", 100)], None, 120),
        (1.2, [("h0", 120)], None, None),
        (1.5, [], "h0", None),
        (0.3, [("h1", 120)], None, None),
        (0.4, [("h0", 120), ("ghost", 1)], None, None),
        (3.5, [], None, None),
    ]
    views = []
    for dt, beats, dead, mesh_step in script:
        clock.t += dt
        for host_id, step in beats:
            both(lambda c: c._rpc_heartbeat(
                {"host_id": host_id, "step": step,
                 "metrics": {"fleet_estimated_drain_s": step / 1000}}))
        if dead is not None:
            both(lambda c: c.mark_dead(dead, "meta-router: probe"))
        if mesh_step is not None:
            for c in coords:
                c._mesh_step = mesh_step
        views.append(both(_view))
        for c in coords:
            c.sweep()
        views.append(both(_view))
    states = {h["state"] for view in views for h in view[0]}
    assert states == {HOST_ALIVE, HOST_SUSPECT, HOST_DEAD}


def test_meta_router_scores_and_picks_as_jax():
    """The same gossiped drains (and in-flight counts) in both packages'
    coordinators: both MetaRouters score every host alike and pick the
    same one, ties included."""
    coords = [MeshCoordinator(lease_s=30.0, dead_after_s=30.0),
              JaxCoordinator(lease_s=30.0, dead_after_s=30.0)]
    routers = [MetaRouter(coords[0]), JaxMetaRouter(coords[1])]
    for c in coords:
        for i in range(4):
            _register(c, f"host{i}")
    rng = np.random.default_rng(5)
    for trial in range(12):
        drains = rng.choice([0.0, 0.01, 0.2, 1.5], size=4)
        inflight = rng.integers(0, 3, size=4)
        for c, r in zip(coords, routers):
            for i in range(4):
                metrics = {"fleet_estimated_drain_s": float(drains[i])}
                if trial % 5 == 4:
                    metrics = {"fleet_estimated_drain_s": "garbage"}
                c._hosts[f"host{i}"].metrics = metrics
                r._inflight[f"host{i}"] = int(inflight[i])
        picks = []
        for r in routers:
            hosts = r._eligible_hosts()
            picks.append(([r._score(h) for h in hosts],
                          min(hosts, key=r._score).host_id))
        assert picks[0] == picks[1], trial


def test_no_routable_hosts_is_typed():
    coord = MeshCoordinator().serve()
    try:
        with pytest.raises(NoHealthyHosts):
            MetaRouter(coord).predict(_obs())
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# A port host against JAX's coordinator
# ---------------------------------------------------------------------------


def test_port_agent_against_jax_coordinator(tmp_path):
    """A port host stack registers and heartbeats with JAX's coordinator
    (its gossip carries the port's fleet metrics), JAX's coordinator
    drives a global two-phase swap on it, and when its heartbeats stop it
    walks suspect then dead under JAX's lease_s and dead_after_s."""
    _write_ckpt(tmp_path, 100, _make_model(0))
    coord = JaxCoordinator(log_dir=tmp_path, lease_s=0.4,
                           dead_after_s=1.5).serve()
    stack = build_inprocess_host(tmp_path, coord.url, "porthost",
                                 obs_dim=OBS_DIM, heartbeat_s=0.1,
                                 device="cpu")
    router, fleet, frontend, agent = stack
    try:
        assert agent.wait_registered(10.0)
        deadline = time.monotonic() + 5.0
        while agent.beats_sent < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        (host,) = coord.hosts()
        assert host["state"] == "alive" and host["step"] == 100
        assert "fleet_estimated_drain_s" in coord._hosts["porthost"].metrics
        _write_ckpt(tmp_path, 200, _make_model(1))
        assert coord.refresh() is True
        assert coord.last_commit == {"commit_round": 1, "host_count": 1,
                                     "step": 200}
        assert fleet.fleet_step == 200
        assert router.submit(_obs()).result(timeout=10).model_step == 200
        seen = [coord.hosts()[0]["state"]]
        agent.stop(deregister=False)  # the heartbeats stop
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            state = coord.hosts()[0]["state"]
            if not seen or seen[-1] != state:
                seen.append(state)
            if state == "dead":
                break
            time.sleep(0.02)
        assert seen == ["alive", "suspect", "dead"]
    finally:
        agent.stop(deregister=False)
        frontend.stop()
        router.stop()
        coord.stop()


# ---------------------------------------------------------------------------
# In-process loopback hosts (threads, real HTTP/RPC)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="class")
def mesh2(tmp_path_factory):
    """Coordinator + 2 in-process hosts + MetaRouter over a promoted
    directory seeded at step 100; swap tests publish ascending steps
    relative to the CURRENT mesh step."""
    previous = set_registry(MetricsRegistry()), set_tracer(Tracer())
    promoted = tmp_path_factory.mktemp("mesh_promoted")
    model = _make_model()
    _write_ckpt(promoted, 100, model)
    coord = MeshCoordinator(log_dir=promoted, lease_s=2.0, dead_after_s=2.0,
                            prepare_timeout_s=10.0).serve()
    stacks = [build_inprocess_host(promoted, coord.url, f"host{i}",
                                   obs_dim=OBS_DIM, buckets=(1,),
                                   heartbeat_s=0.1, device="cpu")
              for i in range(2)]
    for _, _, _, agent in stacks:
        assert agent.wait_registered(15.0)
    yield {"coord": coord, "router": MetaRouter(coord, probe_interval_s=0.3),
           "stacks": stacks, "promoted": promoted, "model": model}
    _stop_stacks(stacks)
    coord.stop()
    set_registry(previous[0])
    set_tracer(previous[1])


class TestInProcessMesh:
    """The JAX tests' in-process mesh: its coordinator and hosts live for
    this class only (their heartbeats cross the process's fault plane, so
    they are down before the storm below arms it)."""

    def test_meta_router_serves_and_routes_by_gossiped_drain(self, mesh2):
        router, coord = mesh2["router"], mesh2["coord"]
        result = router.predict(_obs())
        assert result.host in ("host0", "host1") and result.replica >= 0
        busy = result.host
        idle = "host1" if busy == "host0" else "host0"
        # The busy host gossips a deep backlog through its own heartbeats
        # (its /v1/metrics snapshot), so no beat can overwrite the view
        # between the gossip and the routing decision.
        stack = mesh2["stacks"][int(busy[-1])][0]
        honest = stack.snapshot
        stack.snapshot = lambda: {**honest(), "fleet_estimated_drain_s": 9.0}
        try:
            deadline = time.monotonic() + 5.0
            while (coord._hosts[busy].metrics.get("fleet_estimated_drain_s")
                   != 9.0 and time.monotonic() < deadline):
                time.sleep(0.02)
            assert coord._hosts[idle].metrics.get(
                "fleet_estimated_drain_s", 0.0) < 9.0
            for _ in range(3):
                assert router.predict(_obs()).host == idle
        finally:
            del stack.snapshot
        time.sleep(0.3)
        snap = router.snapshot()
        assert snap["mesh_hosts"] == 2.0
        assert snap["mesh_routed_total"] >= 2.0
        # The gossip is each host's /v1/metrics: its fleet families and the
        # port's kernel launch counts (0 off the card).
        metrics = coord._hosts["host0"].metrics
        assert metrics["knn_fused_launches"] == 0.0
        assert metrics["rung1_f32_replicated_compiles"] == 1.0

    def test_global_swap_is_monotonic_in_completion_order(self, mesh2):
        router, coord = mesh2["router"], mesh2["coord"]
        witness, lock, stop = [], threading.Lock(), threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    r = router.predict(_obs(), timeout_s=5.0)
                except Exception:  # noqa: BLE001 — typed errors are fine
                    continue
                with lock:
                    witness.append((time.perf_counter(), r.model_step))

        threads = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.3)
            new_step = coord.fleet_step + 100
            _write_ckpt(mesh2["promoted"], new_step, mesh2["model"])
            assert coord.refresh() is True
            assert coord.fleet_step == new_step
            assert coord.last_commit["host_count"] == 2
            assert coord.last_commit["commit_round"] >= 1
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if router.predict(_obs()).model_step == new_step:
                    break
            time.sleep(0.2)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
        with lock:
            assert check_step_monotonic(witness) == []
            assert witness and max(s for _, s in witness) == new_step
        for _, fleet, _, _ in mesh2["stacks"]:
            assert fleet.fleet_step == new_step

    def test_trace_id_through_the_extra_hop(self, mesh2):
        router = mesh2["router"]
        assert router.predict(_obs(), trace_id="mesh-trace-42").trace_id == (
            "mesh-trace-42")
        frontend = MeshFrontend(router).start()
        try:
            req = urllib.request.Request(
                frontend.url + "/v1/act",
                data=json.dumps({"obs": _obs().tolist()}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Trace-Id": "mesh-trace-43"},
            )
            with urllib.request.urlopen(req) as resp:
                assert resp.headers.get("X-Trace-Id") == "mesh-trace-43"
                body = json.loads(resp.read())
            assert body["trace_id"] == "mesh-trace-43"
            assert body["host"] in ("host0", "host1")
            assert body["model_step"] == mesh2["coord"].fleet_step
            with urllib.request.urlopen(frontend.url + "/v1/health") as resp:
                health = json.loads(resp.read())
            assert health["routable_hosts"] == 2 and health["hosts"] == 2
        finally:
            frontend.stop()

    def test_serving_client_endpoint_failover(self, mesh2):
        live = [fe.url for _, _, fe, _ in mesh2["stacks"]]
        client = ServingClient(["http://127.0.0.1:1"] + live, max_retries=2,
                               backoff_base_s=0.001)
        actions, step = client.predict(_obs())
        assert actions.shape == (1, 2) and step == mesh2["coord"].fleet_step
        client = ServingClient(["http://127.0.0.1:1"] * 2, max_retries=1,
                               backoff_base_s=0.001)
        with pytest.raises(ConnectionError):
            client.predict(_obs())

    def test_catch_up_after_missed_commit(self, mesh2):
        coord = mesh2["coord"]
        router_b, fleet_b, frontend_b, agent_b = mesh2["stacks"][1]
        agent_b.stop(deregister=True)
        new_step = coord.fleet_step + 100
        _write_ckpt(mesh2["promoted"], new_step, mesh2["model"])
        assert coord.refresh() is True
        assert coord.last_commit["host_count"] == 1
        assert fleet_b.fleet_step < new_step
        agent_new = HostAgent(host_id="host1", router=router_b, fleet=fleet_b,
                              coordinator_url=coord.url,
                              data_url=frontend_b.url,
                              heartbeat_interval_s=0.1).start()
        mesh2["stacks"][1] = (router_b, fleet_b, frontend_b, agent_new)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if ("host1" in {h.host_id for h in coord.routable_hosts()}
                    and fleet_b.fleet_step == new_step
                    and agent_new.catch_ups >= 1):
                break
            time.sleep(0.05)
        assert fleet_b.fleet_step == new_step
        assert "host1" in {h.host_id for h in coord.routable_hosts()}
        assert agent_new.catch_ups >= 1

    def test_wedged_host_barrier_abort_restores_every_host(self, mesh2):
        coord, router = mesh2["coord"], mesh2["router"]
        old_step = coord.fleet_step
        plane = get_fault_plane()
        plane.reset()
        plane.arm(FaultSchedule(
            [FaultSpec("mesh.prepare", "wedge", at_hit=1, seconds=1.5)]))
        plane.enabled = True
        coord.prepare_timeout_s, saved = 0.5, coord.prepare_timeout_s
        try:
            path = _write_ckpt(mesh2["promoted"], old_step + 100,
                               mesh2["model"])
            assert coord.global_reload(path) is False
            assert coord.fleet_step == old_step
            assert any("abort" in reason for _, reason in coord.load_errors)
            for _, fleet, _, _ in mesh2["stacks"]:
                assert fleet.fleet_step == old_step
            assert router.predict(_obs()).model_step == old_step
            plane.enabled = False
            time.sleep(1.0)  # the wedged prepare runs out meanwhile
            deadline = time.monotonic() + 15.0
            landed = False
            while time.monotonic() < deadline and not landed:
                landed = coord.global_reload(path)
                if not landed:
                    time.sleep(0.2)
            assert landed, list(coord.load_errors)
            for _, fleet, _, _ in mesh2["stacks"]:
                assert fleet.fleet_step == old_step + 100
        finally:
            plane.enabled = False
            plane.reset()
            coord.prepare_timeout_s = saved


def test_commit_retry_is_idempotent_and_already_at_step_short_circuits(
        tmp_path):
    _write_ckpt(tmp_path, 100, _make_model(0))
    coord = MeshCoordinator(lease_s=5.0, dead_after_s=5.0).serve()
    router, fleet, frontend, agent = build_inprocess_host(
        tmp_path, coord.url, "h0", obs_dim=OBS_DIM, buckets=(1,),
        device="cpu")
    try:
        path = _write_ckpt(tmp_path, 150, _make_model(1))
        resp = rpc_call(agent.control_url, "mesh.prepare",
                        {"round": 7, "path": str(path), "step": 150,
                         "ttl_s": 30.0})
        assert resp["staged"] is True
        first = rpc_call(agent.control_url, "mesh.commit", {"round": 7})
        assert first == {"ok": True, "step": 150}
        retry = rpc_call(agent.control_url, "mesh.commit", {"round": 7})
        assert retry == {"ok": True, "step": 150}
        assert fleet.fleet_step == 150
        resp = rpc_call(agent.control_url, "mesh.prepare",
                        {"round": 8, "path": str(path), "step": 150,
                         "ttl_s": 30.0})
        assert resp["already_at_step"] is True and not resp["staged"]
        # A commit for a round never staged here is refused.
        refused = rpc_call(agent.control_url, "mesh.commit", {"round": 9})
        assert refused["ok"] is False and "not staged" in refused["reason"]
        assert router.submit(_obs()).result(timeout=10.0).model_step == 150
    finally:
        agent.stop()
        frontend.stop()
        router.stop()
        coord.stop()


def test_prepare_ttl_aborts_an_orphaned_round(tmp_path):
    """A staged round whose coordinator never commits or aborts (it died
    mid-round): the host's prepare TTL resumes it on the old step, gates
    open, refresh lock free for the next round."""
    _write_ckpt(tmp_path, 100, _make_model(0))
    coord = MeshCoordinator(lease_s=5.0, dead_after_s=5.0).serve()
    router, fleet, frontend, agent = build_inprocess_host(
        tmp_path, coord.url, "h0", obs_dim=OBS_DIM, buckets=(1,),
        device="cpu")
    try:
        path = _write_ckpt(tmp_path, 150, _make_model(1))
        staged, reason = fleet.prepare_global(path, ttl_s=1.0)
        assert staged, reason
        busy, why = fleet.prepare_global(path)
        assert not busy and "awaiting commit/abort" in why
        deadline = time.monotonic() + 5.0
        while fleet._staged is not None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fleet._staged is None and fleet.fleet_step == 100
        assert any("TTL expired" in r for _, r in fleet.load_errors)
        assert router.submit(_obs()).result(timeout=10.0).model_step == 100
        assert fleet.reload_pinned(path) is True
        assert fleet.fleet_step == 150
    finally:
        agent.stop()
        frontend.stop()
        router.stop()
        coord.stop()


# ---------------------------------------------------------------------------
# A global swap on a GNN against the single engine and the JAX engine
# ---------------------------------------------------------------------------

N_AGENTS, K = 6, 2


def test_global_swap_on_a_gnn_equals_the_engine_and_jax(tmp_path):
    env = EnvParams(num_agents=N_AGENTS, obs_mode="knn", knn_k=K)
    jax_env = JaxEnvParams(num_agents=N_AGENTS, obs_mode="knn", knn_k=K)
    models = [GNNActorCritic(k=K, generator=torch.Generator().manual_seed(s))
              for s in (0, 1)]
    promoted = tmp_path / "promoted"
    _write_ckpt(promoted, 100, models[0])
    coord = MeshCoordinator(log_dir=promoted, lease_s=5.0,
                            dead_after_s=5.0).serve()
    stacks = [build_inprocess_host(promoted, coord.url, f"host{i}",
                                   env_params=env, buckets=(1, 8),
                                   heartbeat_s=0.1, device="cpu")
              for i in range(2)]
    try:
        for *_, agent in stacks:
            assert agent.wait_registered(10.0)
        path = _write_ckpt(promoted, 200, models[1])
        assert coord.refresh() is True
        assert coord.last_commit["host_count"] == 2
        engine = BucketedPolicyEngine(
            LoadedPolicy.from_checkpoint(path, env_params=env,
                                         device="cpu"), buckets=(1, 8))
        jax_engine = JaxEngine(
            JaxLoadedPolicy.from_checkpoint(path, env_params=jax_env),
            buckets=(1, 8))
        from marl_distributedformation_tpu_torch.serving.mesh.host import (
            probe_rows,
        )

        for n in (1, 5, 8):
            rows = probe_rows(env, n, "cpu", seed=n)
            want = engine.act(rows)
            for _, fleet, frontend, _ in stacks:
                assert fleet.fleet_step == 200
                status, body = _raw(
                    frontend.url, "POST", "/v1/act",
                    json.dumps({"obs": rows.tolist()}).encode(),
                    {"Content-Type": "application/json"})
                assert status == 200
                reply = json.loads(body)
                got = np.asarray(reply["actions"], np.float32)
                assert reply["model_step"] == 200
                assert np.array_equal(got, want), n
            np.testing.assert_allclose(
                want, np.asarray(jax_engine.act(rows)), rtol=RTOL, atol=ATOL)
    finally:
        _stop_stacks(stacks)
        coord.stop()


# ---------------------------------------------------------------------------
# The --mesh storm and always_learning through the mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_storm_report(tmp_path_factory):
    from marl_distributedformation_tpu_torch import chaos_storm

    previous = (set_fault_plane(FaultPlane()), set_registry(MetricsRegistry()),
                set_tracer(Tracer()))
    try:
        return chaos_storm.run_mesh_campaign(
            seed=0, workdir=str(tmp_path_factory.mktemp("mesh_storm")),
            budget_s=150.0, wedge_s=1.2, gate_timeout_s=0.6, device="cpu")
    finally:
        set_fault_plane(previous[0])
        set_registry(previous[1])
        set_tracer(previous[2])


def test_mesh_campaign_zero_violations(mesh_storm_report):
    """The --mesh storm at JAX's tiny default: every armed fault fired,
    0 violations, a global swap landed, the SIGKILLed host dead, the
    survivor's rungs built once each."""
    from marl_distributedformation_tpu_torch import chaos_storm

    report = mesh_storm_report
    assert report["chaos_invariant_violations"] == 0, report.get(
        "chaos_violations")
    assert report["chaos_faults_unfired"] == 0
    expected = chaos_storm.build_schedule(
        0, 20, wedge_s=1.2,
        point_names=chaos_storm.TRAIN_POINTS + chaos_storm.MESH_SERVE_POINTS)
    assert report["deterministic"]["schedule"] == expected.record()
    assert report["chaos_faults_fired"] == len(expected)
    assert report["mesh_global_swaps"] >= 1
    killed = report["mesh_host_killed"]
    assert report["mesh_host_states"][killed] == "dead"
    receipts = report["compile_receipts"]
    assert receipts["gate_matrix"] == 1
    assert set(receipts.values()) == {1} and len(receipts) == 3


def test_mesh_campaign_report_carries_every_jax_key(mesh_storm_report):
    from test_torch_chaos_storm import _jax_report_keys

    # JAX's report keys: its subscript assignments and its literal's
    # "mesh_hosts".
    keys = _jax_report_keys("run_mesh_campaign") | {"mesh_hosts"}
    assert {"mesh_host_states", "mesh_commit_rounds"} <= keys
    port_only = {"compile_receipts", "chaos_fired"}
    assert set(mesh_storm_report) == keys | port_only


def test_always_learning_promotes_through_the_mesh(tmp_path, monkeypatch):
    from marl_distributedformation_tpu_torch import always_learning
    from marl_distributedformation_tpu_torch.train import cli as train_cli

    monkeypatch.setattr(train_cli, "repo_root", lambda: tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    report = always_learning.main([
        "name=always_mesh", "num_formation=4", "num_agents_per_formation=3",
        "n_steps=10", "max_steps=10", "gate_formations=4",
        "pipeline_replicas=1", "device=cpu", "total_timesteps=360",
        "save_freq=1", "pipeline_budget_s=120", "mesh_serve=true",
        "mesh_hosts=2"])
    assert report["promotions"] >= 2 and report["pipeline_errors"] == []
    assert report["mesh_hosts"] == 2 and report["mesh_commit_rounds"] >= 1
    assert sorted(report["mesh_host_states"]) == ["host0", "host1"]
    assert set(report["verified_served_steps"]) == {report["served_step"]}
    assert report["serving_max_compiles_per_rung"] == 1
    log = tmp_path / "logs" / "always_mesh" / "promotions.jsonl"
    records = [json.loads(line) for line in log.read_text().splitlines()]
    meshed = [r for r in records if r["event"] == "promoted"
              and r.get("commit_round") is not None]
    # Schema 4's attribution: the coordinator's rounds, in order, each
    # committed on the hosts its barrier held (both, unless a starved host
    # missed its lease under load).
    rounds = [r["commit_round"] for r in meshed]
    assert rounds and rounds == sorted(set(rounds))
    assert max(r["host_count"] for r in meshed) == 2


# ---------------------------------------------------------------------------
# The real thing: 2 host subprocesses, kill -9, global monotonicity
# ---------------------------------------------------------------------------


def test_two_host_subprocess_e2e_swap_and_kill(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _write_ckpt(tmp_path, 100, _make_model(0))
    mesh = spawn_local_mesh(tmp_path, hosts=2, buckets=(1,),
                            obs_dim=OBS_DIM, heartbeat_s=0.15, lease_s=0.6,
                            dead_after_s=0.6, probe_interval_s=0.3,
                            ready_timeout_s=60.0, device="cpu")
    assert {h.info["device"] for h in mesh.hosts} == {"cpu"}
    witness, lock, stop = [], threading.Lock(), threading.Event()
    outcomes = {"ok": 0, "typed": 0, "lost": 0}

    def hammer():
        while not stop.is_set():
            try:
                r = mesh.router.predict(_obs(), timeout_s=5.0)
            except (NoHealthyHosts, RuntimeError, OSError, TimeoutError):
                with lock:
                    outcomes["typed"] += 1
                time.sleep(0.01)
                continue
            except BaseException:
                with lock:
                    outcomes["lost"] += 1
                continue
            with lock:
                outcomes["ok"] += 1
                witness.append((time.perf_counter(), r.model_step))

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.4)
        path = _write_ckpt(tmp_path, 200, _make_model(1))
        assert mesh.coordinator.global_reload(path) is True
        assert mesh.coordinator.last_commit == {
            "commit_round": 1, "host_count": 2, "step": 200}
        time.sleep(0.4)
        killed = mesh.kill_host(0)
        time.sleep(1.5)
        assert mesh.router.predict(_obs(), timeout_s=5.0).model_step == 200
        states = {h["host_id"]: h["state"] for h in mesh.coordinator.hosts()}
        assert states[killed] == HOST_DEAD
        path = _write_ckpt(tmp_path, 300, _make_model(0))
        assert mesh.coordinator.global_reload(path) is True
        assert mesh.coordinator.last_commit["host_count"] == 1
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if mesh.router.predict(_obs(), timeout_s=5.0).model_step == 300:
                break
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15.0)
        receipts = mesh.router.host_compile_counts()
        mesh.stop()
    assert not any(t.is_alive() for t in threads)
    with lock:
        assert outcomes["lost"] == 0, outcomes
        assert outcomes["ok"] > 0
        assert check_step_monotonic(witness) == []
        assert max(s for _, s in witness) == 300
    assert receipts and set(receipts) == {"host1"}
    for per_rung in receipts.values():
        assert set(per_rung.values()) == {1.0}
    assert all(not h.alive() for h in mesh.hosts)


# ---------------------------------------------------------------------------
# The package surface and the card
# ---------------------------------------------------------------------------


def test_mesh_exports_equal_jax():
    import marl_distributedformation_tpu.serving.mesh as jax_mesh
    import marl_distributedformation_tpu_torch.serving.mesh as port_mesh
    from test_torch_hygiene import _exported

    assert _exported(JAX_MESH) <= set(dir(port_mesh))
    assert sorted(port_mesh.__all__) == sorted(jax_mesh.__all__)


def test_mesh_needs_a_gpu_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    from marl_distributedformation_tpu_torch.serving.mesh import host

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_ckpt(tmp_path, 100, _make_model(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn_local_mesh(tmp_path, obs_dim=OBS_DIM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        host.main(["--promoted-dir", str(tmp_path), "--coordinator-url",
                   "http://127.0.0.1:1", "--host-id", "h0", "--obs-dim",
                   str(OBS_DIM)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_inprocess_host(tmp_path, "http://127.0.0.1:1", "h0",
                             obs_dim=OBS_DIM)
