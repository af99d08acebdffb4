"""Measured scaling of the port's dp and sweep paths over D ranks.

Counterpart of the repository's ``scripts/weak_scaling.py``, with its
rows, columns and knobs. Each rank count D runs as D ``torch.distributed``
ranks started by ``parallel.launch`` (one process a rank, a ``dp`` mesh of
D), and rank 0 prints one JSON line a row:

- ``dp_env`` (fixed TOTAL load, ``WS_M_TOTAL`` formations): the batched
  env step of each rank's block (``parallel.make_dp_step``; its k-NN
  observation through ``knn_fused`` on the card), ``WS_ENV_CHUNK`` steps a
  call. Ideal is flat; growth above the smallest D is the cost of
  splitting the same work.
- ``dp_train`` (fixed TOTAL load, ``WS_M_TRAIN`` formations): one whole
  PPO iteration of a ``Trainer`` on the mesh (the rollout all-gathered,
  the gradients all-reduced), the collective-bearing path.
- ``sweep`` (fixed PER-RANK load: one member of ``WS_M_MEMBER`` formations
  a rank): a ``SweepTrainer`` of D members split over 'dp'; total work
  grows with D.

A call's seconds are the slowest rank's. Every rank times the same number
of calls (rank 0's count, after two warm-up calls: the first builds, the
second captures on the card), so ranks meet at every collective.

**What it measures.** On the CPU (``--device cpu``, gloo) every rank
shares the host's cores, so past D = cores the ranks serialize by
construction, as the JAX script's virtual devices do. On the card
(``--device cuda``) D=1 is one NCCL rank and D=2 two gloo ranks on
``cuda:0`` (``parallel.distributed.choose_backend``): time-sharing one
card, not scaling. Each row says which (``device``, ``backend``,
``note``). It writes no file: the JAX package's ``docs/weak_scaling.md``
stays the JAX script's.

Usage::

    python -m marl_distributedformation_tpu_torch.weak_scaling --device cpu
    WS_DEVICES=1,2 python -m marl_distributedformation_tpu_torch.weak_scaling

Knobs (environment, JAX's names and defaults): ``WS_DEVICES`` (1,2,4,8 on
the CPU; 1,2 on the card), ``WS_M_TOTAL`` 256, ``WS_M_TRAIN`` 64,
``WS_M_MEMBER`` 32, ``WS_ENV_CHUNK`` 64, ``WS_MIN_TIMED_S`` 2.0; N=5.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


M_TOTAL = _env_int("WS_M_TOTAL", 256)  # fixed-total formations, dp_env
M_TRAIN = _env_int("WS_M_TRAIN", 64)  # fixed-total formations, dp_train
M_PER_MEMBER = _env_int("WS_M_MEMBER", 32)  # per-rank load, sweep
N_AGENTS = 5
ENV_CHUNK = _env_int("WS_ENV_CHUNK", 64)  # env steps a timed call
MIN_TIMED_S = float(os.environ.get("WS_MIN_TIMED_S", 2.0))
ROW_KEYS = ("phase", "devices", "seconds_per_call", "steps_per_sec")


def device_counts(device: str) -> List[int]:
    default = "1,2" if device == "cuda" else "1,2,4,8"
    return [int(d) for d in os.environ.get("WS_DEVICES", default).split(",")]


def _time_calls(fn: Callable[[], Any], device: Any) -> float:
    """Two warm-up calls, then the seconds a call over at least
    ``MIN_TIMED_S`` of calls, the same count on every rank (rank 0's), the
    slowest rank's time."""
    import torch

    from marl_distributedformation_tpu_torch.parallel import distributed as pd

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(2):
        fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    probe = max(time.perf_counter() - t0, 1e-6)
    calls = pd.broadcast_object(max(1, math.ceil(MIN_TIMED_S / probe)))
    pd.barrier()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    seconds = (time.perf_counter() - t0) / calls
    return max(pd.all_gather_object(seconds))


def child(device_name: str) -> None:
    """One rank: the three rows over a ``dp`` mesh of every rank; rank 0
    prints them."""
    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.env.formation import reset_batch
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.parallel import (
        init_distributed,
        is_coordinator,
        make_dp_step,
        make_mesh,
        make_shard_fn,
        rank_device,
        shard_batch,
        shutdown_distributed,
    )
    from marl_distributedformation_tpu_torch.parallel import distributed as pd
    from marl_distributedformation_tpu_torch.train import (
        SweepTrainer,
        TrainConfig,
        Trainer,
    )
    from marl_distributedformation_tpu_torch.train.sweep import member_block

    torch.set_num_threads(1)
    init_distributed(device=device_name)
    device = rank_device(device_name)
    n_dev = pd.world_size()
    mesh = make_mesh({"dp": n_dev}, device)
    params = EnvParams(num_agents=N_AGENTS)
    logs = tempfile.mkdtemp(prefix="ws_")

    def emit(phase: str, seconds: float, work_steps: float) -> None:
        if is_coordinator():
            print(json.dumps({
                "phase": phase, "devices": n_dev,
                "seconds_per_call": seconds,
                "steps_per_sec": work_steps / seconds,
            }), flush=True)

    def model(seed: int) -> torch.nn.Module:
        return MLPActorCritic(params.obs_dim, params.act_dim,
                              generator=torch.Generator().manual_seed(seed))

    try:
        # -- dp_env: fixed-total env stepping over 'dp' ------------------
        dp_step = make_dp_step(params, mesh)
        gen = torch.Generator(device=device).manual_seed(0)
        box = {"state": shard_batch(
            reset_batch(params, M_TOTAL, gen, device=device), mesh)}
        vel = torch.ones((M_TOTAL // n_dev, N_AGENTS, 2), device=device)

        def run_chunk() -> None:
            state = box["state"]
            for _ in range(ENV_CHUNK):
                state, _ = dp_step(state, vel, generator=gen)
            box["state"] = state

        emit("dp_env", _time_calls(run_chunk, device), M_TOTAL * ENV_CHUNK)

        # -- dp_train: fixed-total whole PPO iteration --------------------
        ppo = PPOConfig(n_steps=4, batch_size=8 * M_TRAIN, n_epochs=2)
        trainer = Trainer(
            params, ppo=ppo,
            config=TrainConfig(num_formations=M_TRAIN, name="ws",
                               checkpoint=False, log_dir=f"{logs}/train"),
            model=model(0), device=device,
            shard_fn=make_shard_fn(mesh=mesh),
        )
        emit("dp_train", _time_calls(trainer.run_iteration, device),
             ppo.n_steps * M_TRAIN)
        del trainer

        # -- sweep: one member a rank, fixed per-rank load ----------------
        sweep = SweepTrainer(
            params,
            ppo=PPOConfig(n_steps=4, batch_size=8 * M_PER_MEMBER, n_epochs=2),
            config=TrainConfig(num_formations=M_PER_MEMBER, name="ws",
                               checkpoint=False, log_dir=f"{logs}/sweep"),
            num_seeds=n_dev,
            models=[model(i) for i in member_block(n_dev, mesh)],
            mesh=mesh, device=device,
        )
        emit("sweep", _time_calls(sweep.run_iteration, device),
             4 * M_PER_MEMBER * n_dev)
    finally:
        shutdown_distributed()


def _label(device: str, n_dev: int, cores: int) -> Dict[str, str]:
    if device == "cuda":
        backend = "nccl" if n_dev == 1 else "gloo"
        note = ("one rank on one card" if n_dev == 1 else
                f"time-sharing, not scaling: {n_dev} ranks on cuda:0")
    else:
        backend = "gloo"
        note = (f"{n_dev} ranks on {cores} shared host cores"
                + (" (past the core count the ranks serialize)"
                   if n_dev > cores else ""))
    return {"device": device, "backend": backend, "note": note}


def parent(device: str, counts: Sequence[int],
           timeout_s: float = 1800.0) -> List[Dict[str, Any]]:
    """Every D of ``counts`` as D launched ranks; returns the rows (each
    also printed as one JSON line), labelled with the device, backend and
    what the row measures."""
    from marl_distributedformation_tpu_torch.parallel.launch import launch

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(root), os.environ.get("PYTHONPATH"))
                   if p))
    cores = os.cpu_count() or 1
    rows: List[Dict[str, Any]] = []
    for n_dev in counts:
        print(f"[weak_scaling] D={n_dev} on {device} ...", file=sys.stderr,
              flush=True)
        results = launch(
            ["-m", "marl_distributedformation_tpu_torch.weak_scaling",
             "--child", "--device", device],
            nprocs=n_dev, timeout=timeout_s, env=env, cwd=str(root))
        for rank, (code, out) in enumerate(results):
            if code != 0:
                print(out, file=sys.stderr)
                raise SystemExit(f"rank {rank} of D={n_dev} failed ({code})")
        for line in results[0][1].splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                row.update(_label(device, n_dev, cores))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--child", action="store_true",
                    help="run as one rank of a launch (the parent's call)")
    args = ap.parse_args(argv)
    if args.child:
        child(args.device)
        return 0
    from marl_distributedformation_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: raise before any rank starts
    parent(args.device, device_counts(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
