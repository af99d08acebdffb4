"""Mesh smoke: the loopback 2-host acceptance storm.

Counterpart of the JAX package's ``serving/mesh/smoke.py``, with its
report's field names. One call measures:

- ``mesh_req_per_sec`` — client threads hammering the MetaRouter over
  every host for ``duration_s``;
- ``mesh_global_swap_latency_s_p50`` / ``_p95`` — wall time of
  coordinator-driven global reloads (prepare + commit across every
  host) under that load, measured over ``swaps`` ascending checkpoints;
- ``mesh_failover_lost_requests`` — accepted requests that never
  resolved (result or typed error) across a REAL ``kill -9`` of one
  host mid-load; the no-accepted-request-lost invariant demands 0;
- ``mesh_host_compile_receipts_max`` — the budget-1 receipt (CUDA-graph
  captures a rung on the card), per host, scraped from each host's
  ``/v1/metrics``: every host's just before the kill, the survivors' at
  the end.

Also asserts the global monotonicity witness over every completed
response (``mesh_step_violations`` must be 0 — the same checker the
chaos storm runs).

The JAX smoke trains a 3-agent MLP and publishes byte copies of its
checkpoint. Here ``checkpoints`` may name the files to serve instead (the
first at boot, the swaps cycling through the rest, then the first again,
so each swap changes the parameters; a round that aborts, a host dying
under it, is retried with the same file), with the run's ``env_params``,
request ``rows`` (a pool of whole formations or rows; zeros of one row
by default) and ``on_commit(mesh, step, source)``, called after each
landed swap while the clients are held (no request in flight): a caller
holds every live host's answers against its own engine there. The
report adds each host's ``knn_fused`` launches (``host.py``), its ready
line and the aborted rounds.
"""

from __future__ import annotations

import itertools
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from marl_distributedformation_tpu_torch.serving.mesh.host import (
    write_run_config,
)
from marl_distributedformation_tpu_torch.serving.mesh.loopback import (
    spawn_local_mesh,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    checkpoint_path,
    checkpoint_step,
    latest_checkpoint,
)


def make_checkpoint_series(
    log_dir: str | Path,
    promoted_dir: str | Path,
    num_agents: int = 3,
    num_formations: int = 4,
    iterations: int = 2,
    device: Any = "cuda",
) -> Tuple[Path, int]:
    """Train a tiny policy on ``device`` and publish its newest checkpoint
    into ``promoted_dir`` — the minimum a mesh needs to boot. Returns the
    promoted path and its step."""
    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )

    log_dir = Path(log_dir)
    promoted_dir = Path(promoted_dir)
    promoted_dir.mkdir(parents=True, exist_ok=True)
    env = EnvParams(num_agents=num_agents, max_steps=20)
    per_iter = num_formations * num_agents * 5
    Trainer(
        env,
        ppo=PPOConfig(n_steps=5, n_epochs=1, batch_size=32),
        config=TrainConfig(
            num_formations=num_formations,
            total_timesteps=iterations * per_iter,
            save_freq=1,
            name="mesh_smoke",
            log_dir=str(log_dir),
            seed=0,
        ),
        model=MLPActorCritic(env.obs_dim, env.act_dim,
                             generator=torch.Generator().manual_seed(0)),
        device=device,
    ).train()
    src = latest_checkpoint(log_dir)
    if src is None:
        raise RuntimeError(f"trainer left no checkpoint under {log_dir}")
    dst = promoted_dir / src.name
    shutil.copyfile(src, dst)
    return dst, checkpoint_step(dst)


def publish_next(
    promoted_dir: Path, src: Path, step: int
) -> Tuple[Path, int]:
    """Byte-copy ``src`` to an advanced step under the atomic-rename
    discipline — the storm's synthetic-candidate trick (exactly what a
    still-running trainer would provide)."""
    dst = checkpoint_path(promoted_dir, step)
    tmp = dst.with_name(f".{dst.name}.tmp")
    shutil.copyfile(src, tmp)
    tmp.replace(dst)
    return dst, step


class StepWitness:
    """Response-completion-order monotonicity recorder shared by the
    smoke's client threads (the chaos prober's ``steps`` shape)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.steps: List[Tuple[float, int]] = []
        self.ok = 0
        self.typed_errors = 0
        self.lost = 0

    def record(self, step: int) -> None:
        with self.lock:
            self.ok += 1
            self.steps.append((time.perf_counter(), int(step)))

    def violations(self) -> int:
        from marl_distributedformation_tpu_torch.chaos import (
            check_step_monotonic,
        )

        with self.lock:
            return len(check_step_monotonic(self.steps))


class _Hold:
    """Clients pass ``gate()`` before each request; ``hold()`` stops new
    requests and waits for the ones in flight."""

    def __init__(self) -> None:
        self._open = threading.Event()
        self._open.set()
        self._lock = threading.Lock()
        self._inflight = 0

    def gate(self, stop: threading.Event) -> bool:
        while not self._open.wait(0.05):
            if stop.is_set():
                return False
        with self._lock:
            self._inflight += 1
        return True

    def done(self) -> None:
        with self._lock:
            self._inflight -= 1

    def hold(self, timeout_s: float = 30.0) -> None:
        self._open.clear()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    return
            time.sleep(0.002)
        raise TimeoutError("clients still in flight after the hold")

    def release(self) -> None:
        self._open.set()


def run_mesh_smoke(
    workdir: str | Path,
    hosts: int = 2,
    duration_s: float = 6.0,
    swaps: int = 3,
    clients: int = 4,
    num_agents: int = 3,
    buckets: Tuple[int, ...] = (1, 8),
    kill_host: bool = True,
    per_iter: int = 60,
    ready_timeout_s: float = 120.0,
    device: Any = "cuda",
    checkpoints: Optional[Sequence[str | Path]] = None,
    env_params: Any = None,
    rows: Any = None,
    on_commit: Optional[Callable[[Any, int, Path], None]] = None,
) -> Dict[str, Any]:
    """The whole acceptance storm on ``device``; returns the report dict."""
    import numpy as np

    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.serving.mesh.router import (
        NoHealthyHosts,
    )
    from marl_distributedformation_tpu_torch.serving.scheduler import (
        BackpressureError,
        RequestTimeout,
    )

    workdir = Path(workdir)
    promoted = workdir / "promoted"
    if checkpoints is None:
        src, step0 = make_checkpoint_series(
            workdir / "train", promoted, num_agents=num_agents,
            device=device,
        )
        sources = [src]
        env = EnvParams(num_agents=num_agents, max_steps=20)
    else:
        sources = [Path(c) for c in checkpoints]
        promoted.mkdir(parents=True, exist_ok=True)
        src = promoted / sources[0].name
        shutil.copyfile(sources[0], src)
        step0 = checkpoint_step(src)
        env = env_params
        if env is not None:
            # The hosts read the run's env params beside its checkpoints.
            write_run_config(workdir, env)
    if rows is None:
        rows = np.zeros((1, env.obs_dim), np.float32)
    rows = np.asarray(rows, np.float32)
    mesh = spawn_local_mesh(
        promoted,
        hosts=hosts,
        buckets=buckets,
        num_agents=num_agents if checkpoints is None else None,
        ready_timeout_s=ready_timeout_s,
        probe_interval_s=0.5,
        device=device,
    )
    witness = StepWitness()
    stop = threading.Event()
    hold = _Hold()

    def client_loop(index: int) -> None:
        picks = itertools.count(index)
        while not stop.is_set():
            if not hold.gate(stop):
                return
            # One request: a formation (or row) of the pool, in turn.
            obs = rows[next(picks) % len(rows)][None]
            try:
                result = mesh.router.predict(obs, timeout_s=5.0)
            except (
                BackpressureError,
                RequestTimeout,
                NoHealthyHosts,
                RuntimeError,
                OSError,
            ):
                with witness.lock:
                    witness.typed_errors += 1
                time.sleep(0.01)
                continue
            except BaseException:
                with witness.lock:
                    witness.lost += 1  # untyped = a lost request
                continue
            finally:
                hold.done()
            witness.record(result.model_step)

    threads = [
        threading.Thread(target=client_loop, args=(i,), daemon=True)
        for i in range(clients)
    ]
    swap_latencies: List[float] = []
    killed: Optional[str] = None
    receipts_at_kill: Dict[str, Dict[str, float]] = {}
    launches: Dict[str, float] = {}
    held_s = 0.0
    aborted = 0
    path: Optional[Path] = None
    source = src
    cycle = itertools.cycle(sources[1:] + sources[:1])
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # Load-phase swaps: ascending candidates committed through the
        # coordinator barrier while clients hammer.
        step = step0
        swap_every = duration_s / (swaps + 1)
        next_swap = t0 + swap_every
        kill_at = t0 + duration_s * 0.5
        while time.perf_counter() - t0 < duration_s + held_s:
            now = time.perf_counter()
            if kill_host and killed is None and now >= kill_at + held_s:
                receipts_at_kill = mesh.router.host_compile_counts()
                launches.update(_host_launches(mesh))
                killed = mesh.kill_host(0)
            if len(swap_latencies) < swaps and now >= next_swap:
                if path is None:
                    step += per_iter
                    source = (next(cycle) if checkpoints is not None
                              else src)
                    path, _ = publish_next(promoted, source, step)
                t_swap = time.perf_counter()
                if mesh.coordinator.global_reload(path):
                    swap_latencies.append(time.perf_counter() - t_swap)
                    path = None
                    if on_commit is not None:
                        t_hold = time.perf_counter()
                        hold.hold()
                        try:
                            on_commit(mesh, step, source)
                        finally:
                            hold.release()
                            held_s += time.perf_counter() - t_hold
                    next_swap = time.perf_counter() + swap_every
                else:
                    # A round aborted (a host died under it): the same
                    # checkpoint again shortly, once the dead host is out
                    # of the round.
                    aborted += 1
                    next_swap = time.perf_counter() + 0.25
            time.sleep(0.02)
        elapsed = time.perf_counter() - t0 - held_s
    finally:
        stop.set()
        hold.release()
        for t in threads:
            t.join(timeout=15.0)
        receipts = mesh.router.host_compile_counts()
        launches.update(_host_launches(mesh))
        final_round = mesh.coordinator.commit_round
        final_step = mesh.coordinator.fleet_step
        mesh.stop()
    for t in threads:
        if t.is_alive():
            witness.lost += 1  # a thread wedged inside a request
    swap_latencies.sort()

    def pct(q: float) -> Optional[float]:
        if not swap_latencies:
            return None
        idx = min(len(swap_latencies) - 1, int(q * len(swap_latencies)))
        return round(swap_latencies[idx], 4)

    merged = {**receipts_at_kill, **receipts}
    max_receipt = max(
        (c for per in merged.values() for c in per.values()),
        default=0.0,
    )
    return {
        "mesh_hosts": hosts,
        "mesh_req_per_sec": round(witness.ok / max(elapsed, 1e-9), 1),
        "mesh_requests_ok": witness.ok,
        "mesh_typed_errors": witness.typed_errors,
        "mesh_failover_lost_requests": witness.lost,
        "mesh_step_violations": witness.violations(),
        "mesh_global_swaps": len(swap_latencies),
        "mesh_global_swap_latency_s_p50": pct(0.50),
        "mesh_global_swap_latency_s_p95": pct(0.95),
        "mesh_host_killed": killed,
        "mesh_commit_rounds": final_round,
        "mesh_final_step": final_step,
        "mesh_host_compile_receipts_max": max_receipt,
        "mesh_host_compile_receipts": merged,
        "mesh_host_knn_fused_launches": launches,
        "mesh_hosts_ready": [h.info for h in mesh.hosts],
        "mesh_aborted_rounds": aborted,
        "mesh_load_seconds": round(elapsed, 3),
    }


def _host_launches(mesh: Any) -> Dict[str, float]:
    """Each reachable host's ``knn_fused`` launches from its gossip (the
    heartbeat's ``/v1/metrics`` snapshot)."""
    out = {}
    for h in mesh.coordinator.routable_hosts():
        value = (h.metrics or {}).get("knn_fused_launches")
        if value is not None:
            out[h.host_id] = float(value)
    return out
