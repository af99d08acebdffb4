"""Loopback mesh: a real multi-process mesh on one machine.

Counterpart of the JAX package's ``serving/mesh/loopback.py``. The mesh
tier needs no collectives: the control plane coordinates over RPC and the
data plane over HTTP, both of which loopback exercises for real.
:func:`spawn_local_mesh` boots the whole topology the tests, the chaos
storm's ``--mesh`` campaign and ``chip_smoke.py`` share:

- a :class:`~.coordinator.MeshCoordinator` RPC service in THIS process,
- N host SUBPROCESSES (``serving/mesh/host.py``: each its own
  interpreter, its own engines and captured rungs; ``kill -9`` of one is
  a real host death), all on ``device`` (``cuda``: every host shares
  ``cuda:0`` on a one-card machine),
- a :class:`~.router.MetaRouter` (+ optional :class:`~.router.
  MeshFrontend`) routing over them.

On the card the parent builds the k-NN library (``csrc/knn.cu``) before it
spawns any host, so no two hosts build it at once and every host finds
it built (its ready line says so, ``kernels_prebuilt``). The hosts start
together and the parent waits for every ready line.

:func:`build_inprocess_host` is the thread-level twin for unit tests: the
same fleet + frontend + agent stack, wired over real loopback HTTP/RPC,
but inside the current process where the chaos plane and assertions can
reach it.
"""

from __future__ import annotations

import json
import os
import select
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from marl_distributedformation_tpu_torch.serving.mesh.coordinator import (
    MeshCoordinator,
)
from marl_distributedformation_tpu_torch.serving.mesh.router import (
    MeshFrontend,
    MetaRouter,
)

REPO_ROOT = Path(__file__).resolve().parents[3]


class MeshHostProcess:
    """One spawned host subprocess plus its parsed ready line."""

    def __init__(self, proc: subprocess.Popen, info: Dict[str, Any]):
        self.proc = proc
        self.info = info
        self.host_id = str(info["host_id"])
        self.data_url = str(info["data_url"])
        self.control_url = str(info["control_url"])
        self.pid = int(info["pid"])
        self.step = int(info.get("step", -1))

    def kill(self, sig: int = signal.SIGKILL) -> None:
        """A REAL host death — the failure mode SimulatedCrash only
        imitates."""
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def alive(self) -> bool:
        return self.proc.poll() is None


class LocalMesh:
    """Handle over the whole loopback topology; ``stop()`` tears down
    hosts, router state, and the coordinator."""

    def __init__(
        self,
        coordinator: MeshCoordinator,
        router: MetaRouter,
        hosts: List[MeshHostProcess],
        frontend: Optional[MeshFrontend] = None,
    ) -> None:
        self.coordinator = coordinator
        self.router = router
        self.hosts = hosts
        self.frontend = frontend

    def kill_host(self, index: int, sig: int = signal.SIGKILL) -> str:
        self.hosts[index].kill(sig)
        return self.hosts[index].host_id

    def stop(self) -> None:
        if self.frontend is not None:
            self.frontend.stop()
        _stop_processes([h.proc for h in self.hosts])
        self.coordinator.stop()

    def __enter__(self) -> "LocalMesh":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def _stop_processes(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def prebuild_kernels(device: Any) -> None:
    """On the card, build the k-NN library in this process before any host
    starts (two hosts building it at once would race on its build
    directory); nothing off the card."""
    import torch

    if torch.device(device).type == "cuda":
        from marl_distributedformation_tpu_torch.ops import _build, knn_cuda

        _build.build([knn_cuda.SOURCE])


def _host_command(
    promoted_dir: str | Path,
    coordinator_url: str,
    host_id: str,
    replicas: int,
    buckets: Sequence[int],
    obs_dim: Optional[int],
    num_agents: Optional[int],
    heartbeat_s: float,
    fault_spec: Optional[List[dict]],
    device: Any,
    extra_args: Sequence[str],
) -> List[str]:
    cmd = [
        sys.executable,
        "-m",
        "marl_distributedformation_tpu_torch.serving.mesh.host",
        "--promoted-dir", str(promoted_dir),
        "--coordinator-url", coordinator_url,
        "--host-id", host_id,
        "--replicas", str(replicas),
        "--buckets", ",".join(str(b) for b in buckets),
        "--heartbeat-s", str(heartbeat_s),
        "--device", str(device),
    ]
    if num_agents is not None:
        cmd += ["--num-agents", str(num_agents)]
    if obs_dim is not None:
        cmd += ["--obs-dim", str(obs_dim)]
    if fault_spec:
        cmd += ["--fault-spec", json.dumps(fault_spec)]
    return cmd + list(extra_args)


def _popen_host(cmd: List[str]) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    return subprocess.Popen(
        cmd,
        cwd=str(REPO_ROOT),
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL
        if os.environ.get("MESH_HOST_STDERR") != "1"
        else None,
        text=True,
    )


def _await_ready(proc: subprocess.Popen, host_id: str,
                 deadline: float, ready_timeout_s: float) -> MeshHostProcess:
    """Block until ``proc``'s ready line, the first JSON object it prints
    (killing it on failure)."""
    line = ""
    while time.monotonic() < deadline:
        remaining = max(0.0, deadline - time.monotonic())
        readable, _, _ = select.select(
            [proc.stdout], [], [], min(remaining, 0.5)
        )
        if readable:
            line = proc.stdout.readline()
            if line.startswith("{"):
                break
            line = ""
        if proc.poll() is not None:
            raise RuntimeError(
                f"mesh host {host_id} exited rc={proc.returncode} "
                "before its ready line (run with MESH_HOST_STDERR=1 "
                "for its stderr)"
            )
    if not line:
        proc.kill()
        raise TimeoutError(
            f"mesh host {host_id} produced no ready line in "
            f"{ready_timeout_s}s"
        )
    info = json.loads(line)
    if not info.get("ready"):
        proc.kill()
        raise RuntimeError(f"mesh host {host_id} not ready: {info}")
    return MeshHostProcess(proc, info)


def spawn_host_process(
    promoted_dir: str | Path,
    coordinator_url: str,
    host_id: str,
    replicas: int = 1,
    buckets: Sequence[int] = (1, 8),
    obs_dim: Optional[int] = None,
    num_agents: Optional[int] = None,
    heartbeat_s: float = 0.25,
    fault_spec: Optional[List[dict]] = None,
    ready_timeout_s: float = 120.0,
    extra_args: Sequence[str] = (),
    device: Any = "cuda",
) -> MeshHostProcess:
    """Spawn one host subprocess on ``device`` and block until its ready
    line (the interpreter's start, the card's and the rungs' captures
    dominate)."""
    prebuild_kernels(device)
    proc = _popen_host(_host_command(
        promoted_dir, coordinator_url, host_id, replicas, buckets, obs_dim,
        num_agents, heartbeat_s, fault_spec, device, extra_args))
    return _await_ready(proc, host_id, time.monotonic() + ready_timeout_s,
                        ready_timeout_s)


def spawn_local_mesh(
    promoted_dir: str | Path,
    hosts: int = 2,
    replicas_per_host: int = 1,
    buckets: Sequence[int] = (1, 8),
    obs_dim: Optional[int] = None,
    num_agents: Optional[int] = None,
    heartbeat_s: float = 0.25,
    lease_s: float = 1.0,
    dead_after_s: float = 1.0,
    prepare_timeout_s: float = 30.0,
    frontend_port: Optional[int] = None,
    watch: bool = False,
    fault_specs: Optional[Dict[int, List[dict]]] = None,
    default_timeout_s: float = 10.0,
    max_failovers: int = 1,
    probe_interval_s: float = 1.0,
    ready_timeout_s: float = 120.0,
    device: Any = "cuda",
) -> LocalMesh:
    """Boot coordinator + N host subprocesses on ``device`` + MetaRouter,
    blocking until every host registered. ``watch=True`` also starts the
    coordinator's background poll of ``promoted_dir`` (the
    always-learning shape); tests usually drive ``refresh()``
    themselves. ``fault_specs`` maps a host index to the JSON fault
    list armed on that subprocess's chaos plane."""
    from marl_distributedformation_tpu_torch.device import resolve_device

    resolve_device(device)  # cuda without a card raises here, not in a host
    prebuild_kernels(device)
    coordinator = MeshCoordinator(
        log_dir=promoted_dir,
        lease_s=lease_s,
        dead_after_s=dead_after_s,
        prepare_timeout_s=prepare_timeout_s,
    )
    if watch:
        coordinator.start()
    else:
        coordinator.serve()
    procs: List[subprocess.Popen] = []
    hosts_up: List[MeshHostProcess] = []
    try:
        ids = [f"host{i}" for i in range(hosts)]
        for i, host_id in enumerate(ids):
            procs.append(_popen_host(_host_command(
                promoted_dir, coordinator.url, host_id, replicas_per_host,
                buckets, obs_dim, num_agents, heartbeat_s,
                (fault_specs or {}).get(i), device, ())))
        deadline = time.monotonic() + ready_timeout_s
        for proc, host_id in zip(procs, ids):
            hosts_up.append(
                _await_ready(proc, host_id, deadline, ready_timeout_s))
        while time.monotonic() < deadline:
            states = {h["host_id"] for h in coordinator.hosts()}
            if set(ids) <= states:
                break
            time.sleep(0.05)
        else:
            raise TimeoutError(
                f"hosts never registered: have "
                f"{[h['host_id'] for h in coordinator.hosts()]}"
            )
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        coordinator.stop()
        raise
    router = MetaRouter(
        coordinator,
        default_timeout_s=default_timeout_s,
        max_failovers=max_failovers,
        probe_interval_s=probe_interval_s,
    )
    frontend = None
    if frontend_port is not None:
        frontend = MeshFrontend(router, port=frontend_port).start()
    return LocalMesh(coordinator, router, hosts_up, frontend)


def build_inprocess_host(
    promoted_dir: str | Path,
    coordinator_url: str,
    host_id: str,
    obs_dim: Optional[int] = None,
    env_params: Any = None,
    act_dim: int = 2,
    replicas: int = 1,
    buckets: Sequence[int] = (1,),
    heartbeat_s: float = 0.2,
    window_ms: float = 2.0,
    device: Any = "cuda",
):
    """The host stack inside the CURRENT process (thread-level tests):
    returns ``(router, fleet, frontend, agent)``, all started. The
    caller owns teardown (agent/frontend/router stop order)."""
    from marl_distributedformation_tpu_torch.serving.mesh.host import (
        start_host_stack,
    )

    return start_host_stack(
        promoted_dir,
        coordinator_url,
        host_id,
        env_params=env_params,
        obs_dim=obs_dim,
        act_dim=act_dim,
        replicas=replicas,
        buckets=buckets,
        heartbeat_s=heartbeat_s,
        window_ms=window_ms,
        device=device,
    )
