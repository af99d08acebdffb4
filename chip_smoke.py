#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``marl_distributedformation_tpu_torch/csrc`` with ``nvcc``.
2. Hold each k-NN kernel against its plain PyTorch version on the card, at
   the shapes each path gives it — fused: training (M=1024, N=100, k=4)
   and eval (M=4096); tiled: training (M=8, N=1024, k=4) and eval (M=512)
   — and on lattice, duplicate and edge-clipped points (exact ties) and
   masks with fewer than k valid points: ``idx`` and offsets bitwise,
   distances within 1 ulp. Then time the kernel (its device time under
   ``torch.profiler``, and back-to-back calls with CUDA events) and the
   plain version (CUDA events), with the SM clock, power and temperature
   sampled before and after each kernel's window.
3. Drive the port's k-NN swarm evaluation at full width with a GNN from a
   seeded init: N=100, M=4096 for a full episode (1002 steps; the fused
   kernel must launch 1003 times), and N=1024, M=512 for 101 steps (the
   tiled kernel must launch 102 times). Check finite outputs, and that the
   kernel path equals the plain path end to end on a small batch.
4. Evaluate the committed MLP checkpoint (N=5, M=4096, full episode) through
   the port's evaluate CLI: learned > baseline > zero.
5. Train through the port's ``train`` CLI on the card, the iteration
   captured as CUDA graphs (``train/capture.py``):
   - ``gnn100``, the published 100-agent command (GNN, k=4, M=1024,
     ``preset=tpu``, 30 iterations) with ``fused_chunk=10``: ``knn_fused``
     must launch 1 + 30 x 10 times, counted by replay; the mean reward of
     the last 3 iterations must beat the first 3 by 20 and be above 0; the
     checkpoint it wrote, evaluated through the evaluate CLI (M=1024, full
     episode), must rank learned > baseline > zero. Then the same command
     eagerly for 3 iterations, for the captured-to-eager ratio.
   - ``gnn1024`` (M=8, N=1024, ``preset=tpu``, 12 iterations): ``knn_tiled``
     must launch 1 + 12 x 10 times; the last 3 iterations must beat the
     first 3.
   - the ring/MLP default (M=1000, N=5, ``batch_size=64``), 2 iterations
     captured and 1 eager.
   - for every run: seconds an iteration split into rollout and update
     (CUDA events between graph replays), formation-steps/s,
     agent-transitions/s, peak memory, each graph's nodes and capture
     time, and the device's busy share over one profiled captured
     iteration.
   - a 10-step rollout of each trained GNN at its training shape (N=100,
     M=1024; N=1024, M=8), captured through the kernel, against an eager
     rollout through the plain k-NN from one generator state: bitwise.
   - captured against eager training from one seed: the ring/MLP (M=64)
     bitwise after 3 iterations; the GNN (N=100, M=64) within the Adam
     budget (its gather's backward adds with atomics).
   - a ``health=true recovery=true`` run poisoned with NaN once: it must
     end on finite parameters with a rollback in ``recovery.jsonl``.
6. Print the kernels' JSON line (launches and timings at the training
   paths' shapes, those of the eval paths under ``eval``), the card line,
   and the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero with no result when no GPU is found.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from statistics import mean

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "docs/acceptance/tpu_run/rl_model_20480000_steps.msgpack"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Per candidate pair the search does 2 subtractions, 2 multiplies and 1 add
# for the squared distance and 1 compare against the k-th best.
OPS_PER_PAIR = 6
TOL_ULP = 1


START = time.perf_counter()


def elapsed(label: str) -> None:
    """The script's wall time so far, after ``label``: the whole run must
    stay well inside its 1200 s."""
    print(f"[time] {label}: {time.perf_counter() - START:.1f} s since start")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def smi_sample() -> str:
    """SM clock, power draw and limit, and temperature, sampled beside a
    timing window."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def knn_bound_ms(m: int, n: int, k: int, with_valid: bool) -> tuple:
    """Least time for one search: each input byte read once, each output
    byte written once, against M*N*(N-1) candidate pairs."""
    nbytes = m * n * 8 + (m * n if with_valid else 0) + m * n * k * 16
    ops = m * n * (n - 1) * OPS_PER_PAIR
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(event) -> float:
    """Device time of a ``torch.profiler`` event, in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_device_ms(fn, reps: int, key: str) -> float:
    """Device time a launch of the kernel whose name holds ``key``, over
    ``reps`` calls of ``fn`` under ``torch.profiler``: the kernel's own
    time. CUDA events around back-to-back calls measure the host's launch
    path instead (allocation, checks, ctypes) when it is slower than the
    kernel, as it is for ``knn_fused`` on a slow host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key
    ]
    count = sum(e.count for e in events)
    if count != reps:
        raise AssertionError(f"{key}: {count} profiled launches, want {reps}")
    return sum(device_us(e) for e in events) / count / 1e3


def compare(name: str, got, want) -> float:
    """Fails unless idx and offsets are bitwise equal and dists within
    TOL_ULP; returns the largest absolute difference of any output."""
    import torch

    gi, go, gd = got
    wi, wo, wd = want
    if not torch.equal(gi, wi):
        bad = (gi != wi).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: idx differs from the plain version at {bad}")
    if not torch.equal(go, wo):
        raise AssertionError(f"{name}: offsets differ from the plain version")
    ulp = (gd.view(torch.int32).long() - wd.view(torch.int32).long()).abs().max()
    if int(ulp) > TOL_ULP:
        raise AssertionError(f"{name}: dists differ by {int(ulp)} ulp")
    return max(
        float((gd - wd).abs().max()), float((go - wo).abs().max())
    )


def tie_cases(n: int, m: int, device):
    """Points with exact ties: an integer lattice, the lattice duplicated,
    and agents clipped onto the world's edges."""
    import torch

    side = math.isqrt(n - 1) + 1
    g = torch.arange(side * side, device=device)
    lattice = torch.stack([(g % side) * 10.0, (g // side) * 10.0], -1)[:n]
    dup = lattice.clone()
    dup[n // 2:] = lattice[: n - n // 2]
    gen = torch.Generator(device=device).manual_seed(7)
    edge = torch.rand((n, 2), generator=gen, device=device) * 500.0 - 50.0
    edge = torch.minimum(
        edge.clamp_min(0.0), torch.tensor([400.0, 600.0], device=device)
    ).round()
    out = torch.stack([lattice, dup, edge]).float()
    return out.repeat((m + 2) // 3, 1, 1)[:m].contiguous()


def check_kernel(name, kernel, m, n, k, reps):
    """Phase 2 for one kernel: agreement at the main shape, on ties and on
    short masks, then its time beside the plain version's."""
    import torch

    from marl_distributedformation_tpu_torch.ops.knn import knn_batch_torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((m, n, 2), generator=gen, device=dev)
    pts = (pts * torch.tensor([400.0, 600.0], device=dev)).contiguous()
    err = compare(f"{name} ({m},{n},{k})", kernel(pts, k), knn_batch_torch(pts, k))

    ties = tie_cases(n, min(m, 48), dev)
    compare(f"{name} ties", kernel(ties, k), knn_batch_torch(ties, k))

    valid = torch.rand((min(m, 64), n), generator=gen, device=dev) < 0.5
    valid[::4] = False
    valid[::4, : k - 1] = True  # rows with fewer than k valid points
    sub = pts[: valid.shape[0]].contiguous()
    got = kernel(sub, k, valid)
    compare(f"{name} valid", got, knn_batch_torch(sub, k, valid))
    own = torch.arange(n, device=dev)[None, :]
    if not bool((got[0][::4, :, k - 1] == own).all()):
        raise AssertionError(f"{name}: short rows lack their self-loops")

    print(f"[smi] before {name} timing: {smi_sample()}")
    call_ms = time_ms(lambda: kernel(pts, k), reps)
    ms = kernel_device_ms(lambda: kernel(pts, k), reps, f"{name}_kernel")
    print(f"[smi] after {name} timing: {smi_sample()}")
    plain_ms = time_ms(lambda: knn_batch_torch(pts, k), max(2, reps // 20), 1)
    bound_ms, bound_by = knn_bound_ms(m, n, k, with_valid=False)
    print(f"[kernel] {name} ({m},{n},{k}): ok, max_abs_err {err}, "
          f"{ms:.4f} ms on the device, {call_ms:.4f} ms a call back to back, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # "ms" is the kernel's device time; "call_ms" CUDA events around
    # back-to-back calls, which read the host's launch path when that is
    # slower than the kernel.
    return {"shape": [m, n, k], "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def run_swarm(model, params, m, label):
    """One evaluation through the port's entry point with the launch
    counts set to 0 just before and read just after."""
    import torch

    from marl_distributedformation_tpu_torch.eval import (
        episode_length,
        evaluate,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    out = evaluate(policy_act_fn(model, params), params, m, seed=1234,
                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    T = episode_length(params)
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"{label}: non-finite eval output {out}")
    if out["episodes"] != m:
        raise AssertionError(f"{label}: {out['episodes']} episodes, want {m}")
    print(f"[swarm] {label}: M={m} N={params.num_agents} T={T} "
          f"{wall:.2f} s, {m * T / wall:.1f} formation-steps/s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}, return/agent "
          f"{out['episode_return_per_agent']:.3f}")
    return launches, T


def kernel_equals_plain_end_to_end(model, params, m):
    """The whole evaluation with the kernels and with the plain version,
    on the same card from the same seed: equal results."""
    from marl_distributedformation_tpu_torch.eval import evaluate, policy_act_fn

    runs = {}
    for impl in ("auto", "torch"):
        p = params.replace(knn_impl=impl)
        runs[impl] = evaluate(policy_act_fn(model, p), p, m, seed=99,
                              device="cuda")
    if runs["auto"] != runs["torch"]:
        raise AssertionError(f"kernel path {runs['auto']} != plain path "
                             f"{runs['torch']} at N={params.num_agents}")
    print(f"[swarm] N={params.num_agents} M={m}: kernel path == plain path "
          f"({runs['auto']['episode_return_per_agent']:.4f})")


def profile_breakdown(model, params, m, steps=4):
    """``profile_window`` over a short evaluation (``steps`` + 2 steps)."""
    from marl_distributedformation_tpu_torch.eval import evaluate, policy_act_fn

    p = params.replace(max_steps=steps)
    act = policy_act_fn(model, p)

    def run():
        evaluate(act, p, m, seed=5, device="cuda")

    run()
    profile_window(run, f"N={params.num_agents} M={m}, {steps + 2} steps",
                   steps + 2, "step")


def profile_window(run, label, per, unit, top=8):
    """Device time by kernel over one call of ``run`` (warmed up by the
    caller) under ``torch.profiler``, and the device's busy share of the
    window's wall time (profiling slows the host, so the share may read
    low). Prints the ``top`` kernels and every k-NN kernel, in ms per
    ``unit`` (``per`` of them in the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # Only the kernels themselves: an operator's row also carries the
    # device time of the kernels it launched, which would count them twice.
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
    ]
    total = sum(device_us(e) for e in events)
    if total == 0:
        print(f"[profile] {label}: no device time in the trace (not measured)")
        return
    launches = sum(e.count for e in events)
    print(f"[profile] {label}: device busy {total / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * total / wall_us:.1f}%), "
          f"{total / per / 1e3:.4f} ms/{unit}, {launches / per:.0f} kernel "
          f"launches/{unit}")
    # The k-NN kernels always, on the run's own positions, even when they
    # fall outside the top.
    ranked = sorted(events, key=device_us, reverse=True)
    shown = ranked[:top] + [e for e in ranked[top:] if "knn_" in e.key]
    for e in shown:
        print(f"[profile]   {device_us(e) / total * 100:5.1f}%  "
              f"{device_us(e) / per / 1e3:8.4f} ms/{unit}  x{e.count // per:<5d} "
              f"{e.key[:90]}")


# The published 100-agent training command (docs/acceptance/gnn100) and the
# N=1024 one (docs/acceptance/gnn1024), and the TPU record of the first.
GNN100 = ("policy=gnn", "obs_mode=knn", "num_agents_per_formation=100",
          "num_formation=1024", "preset=tpu", "total_timesteps=30720000")
GNN1024 = ("policy=gnn", "obs_mode=knn", "num_agents_per_formation=1024",
           "num_formation=8", "preset=tpu", "total_timesteps=983040")
MLP_DEFAULT = ("total_timesteps=100000",)  # M=1000, N=5: 2 iterations
TPU_GNN100_CURVE = {1: -37.56, 5: -25.94, 10: -9.49, 20: 7.74, 30: 8.71}
LEARN_MARGIN = 20.0
# A captured phase runs eagerly on its first call and is captured on its
# second, so the first two iterations build; the steady split leaves them
# out (one for an eager run).
WARM_ITERATIONS = {True: 2, False: 1}


def record_phases(trainer):
    """Records a CUDA event at the start of each iteration, after its
    rollout (and GAE) and at its end, through ``Trainer.phase_hook``;
    returns the list the events go into, one triple an iteration."""
    import torch

    phases = []

    def hook(phase):
        if phase == "rollout":
            phases.append([])
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        phases[-1].append(event)

    trainer.phase_hook = hook
    return phases


def train_run(name, overrides, label, capture=True):
    """One run of the port's ``train`` CLI on the card (``build_trainer``
    then ``Trainer.train``, as its ``main`` runs them), the launch counts
    set to 0 just before it and read just after; ``capture=False`` runs the
    iteration eagerly. Prints the time an iteration (the warm-up and
    capture iterations left out of the steady split), throughput, peak
    memory and the graphs' sizes; returns ``(trainer, rewards an
    iteration, launches, steady s/iteration)``."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.train import cli

    shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    trainer = cli.build_trainer([f"name={name}", "device=cuda", *overrides],
                                capture=capture)
    events = record_phases(trainer)
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    trainer.phase_hook = None
    lines = (Path(trainer.log_dir) / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{label}: non-finite metrics {r}")
    iters = len(events)
    if len(records) != iters:
        raise AssertionError(f"{label}: {len(records)} records of {iters} "
                             "iterations")
    phase_ms = [(e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))
                for e in events]
    phases = phase_ms[WARM_ITERATIONS[capture]:] or phase_ms
    roll, upd = mean(p[0] for p in phases), mean(p[1] for p in phases)
    s_iter = (roll + upd) / 1e3
    m = trainer.config.num_formations
    n = trainer.env_params.num_agents
    rate = trainer.ppo.n_steps * m / s_iter
    steps_per_iter = trainer.step // iters
    graphs = "; ".join(
        f"{g['phase']} {g['nodes']} nodes, captured in "
        f"{g['capture_s']:.3f} s, {g['calls']} calls"
        for g in trainer.graph_stats() if g["capture_s"] is not None
    ) or "none (eager)"
    print(f"[train] {label} ({'captured' if capture else 'eager'}): {iters} "
          f"iterations in {wall:.2f} s ({wall / iters:.3f} s each with "
          f"start-up, capture and saves); steady {s_iter:.4f} s/iteration = "
          f"rollout+GAE {roll / 1e3:.4f} + update {upd / 1e3:.4f} "
          f"({steps_per_iter} optimizer steps, "
          f"{steps_per_iter / (upd / 1e3):.1f}/s); {rate:.1f} "
          f"formation-steps/s, {rate * n:.1f} agent-transitions/s "
          f"(metrics.jsonl: {records[-1]['env_steps_per_sec']:.1f}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}; graphs: {graphs}")
    return trainer, [r["reward"] for r in records], launches, s_iter


def learning_check(rewards, label, margin):
    first3, last3 = mean(rewards[:3]), mean(rewards[-3:])
    print(f"[learn] {label}: mean reward of the first 3 iterations "
          f"{first3:.3f}, of the last 3 {last3:.3f}")
    if not last3 >= first3 + margin:
        raise AssertionError(f"{label}: last-3 mean {last3:.3f} does not "
                             f"beat first-3 {first3:.3f} by {margin}")
    return first3, last3


def rollout_graph_equals_plain(model, n, m):
    """A 10-step rollout of ``model`` on M formations of N agents captured
    as a CUDA graph through the k-NN kernel ``auto`` picks (warmed up,
    captured, replayed from the generator's state at capture) against an
    eager rollout through the plain k-NN from the same state: bitwise
    equal. The kernel's launches count by replay."""
    import torch

    from marl_distributedformation_tpu_torch.algo import collect_rollout
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        compute_obs,
        reset_batch,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

    dev = torch.device("cuda")
    runs = {}
    for impl in ("auto", "torch"):
        params = EnvParams(num_agents=n, obs_mode="knn", knn_k=4,
                           knn_impl=impl)
        gen = torch.Generator(device=dev).manual_seed(17)
        state = reset_batch(params, m, gen, dev)
        obs = compute_obs(state.agents, state.goal, params)
        start = gen.get_state()
        out = []

        def rollout():
            out[:] = collect_rollout(model, state, obs, gen, params, 10)

        if impl == "auto":
            knn_cuda.reset_launches()
            graph = PhaseGraph("rollout", rollout, [gen])
            graph()  # the warm-up, eager
            gen.set_state(start)
            graph()  # captured, then replayed
            torch.cuda.synchronize()
            launches = dict(knn_cuda.LAUNCHES)
            if sum(launches.values()) != 20:
                raise AssertionError(f"rollout graph launches {launches}, "
                                     "want 10 eager + 10 replayed")
        else:
            rollout()
        runs[impl] = out
    (_, o1, b1, v1), (_, o2, b2, v2) = runs["auto"], runs["torch"]
    for field in ("obs", "actions", "log_probs", "values", "rewards"):
        if not torch.equal(getattr(b1, field), getattr(b2, field)):
            raise AssertionError(f"rollout {field}: graph through the kernel "
                                 "!= eager plain path")
    if not (torch.equal(o1, o2) and torch.equal(v1, v2)):
        raise AssertionError("rollout last obs/value: graph != eager plain")
    print(f"[rollout] N={n} M={m}, 10 steps: captured graph through the "
          f"kernel == eager plain path bitwise (obs, actions, log_probs, "
          f"values, rewards); {graph.nodes} nodes; launches {launches}")


def _carry(trainer):
    """The trainer's state as tensors: parameters, Adam state, step, env
    carry, the metrics ring and the generator."""
    it = trainer._iteration
    return {
        **{f"param {k}": p.detach().clone()
           for k, p in trainer.model.named_parameters()},
        **{f"mu {k}": v.clone() for k, v in trainer.opt_state.mu.items()},
        **{f"nu {k}": v.clone() for k, v in trainer.opt_state.nu.items()},
        "count": trainer.opt_state.count.clone(), "step": it.step.clone(),
        "agents": it.env.agents.clone(), "obs": it.obs.clone(),
        "metrics": it.ring.buf.clone(),
        "generator": trainer.generator.get_state(),
    }


def captured_equals_eager(kind, iterations=3):
    """Two trainers from one seed on the card, one captured and one eager,
    ``iterations`` iterations each (the last fully replayed): the MLP's
    parameters, Adam state, step, env carry, metrics and generator bitwise
    equal; the GNN's parameters within ``tests/adam_budget.py``'s budget
    (``lr`` a step: the gather's backward adds with atomics, so two GNN
    updates on the card are not bitwise), its generator equal."""
    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import (
        GNNActorCritic,
        MLPActorCritic,
    )
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )

    if kind == "mlp":
        params, m, ppo = EnvParams(), 64, PPOConfig()
    else:
        params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
        m, ppo = 64, PPOConfig(batch_size=16384)
    carries = {}
    for capture in (True, False):
        gen = torch.Generator().manual_seed(3)
        model = (MLPActorCritic(params.obs_dim, generator=gen)
                 if kind == "mlp" else GNNActorCritic(k=4, generator=gen))
        trainer = Trainer(
            params, ppo,
            TrainConfig(num_formations=m, seed=3, checkpoint=False,
                        log_dir=str(ROOT / "logs" / "smoke_compare")),
            model=model, device="cuda", capture=capture,
        )
        for _ in range(iterations):
            trainer.run_iteration()
        torch.cuda.synchronize()
        carries[capture] = _carry(trainer)
    got, want = carries[True], carries[False]
    updates = trainer.step
    atol = 3e-8 + ppo.learning_rate * updates  # tests/adam_budget.py
    worst = 0.0
    for key in want:
        if kind == "gnn" and key.startswith("param"):
            worst = max(worst, float((got[key] - want[key]).abs().max()))
        elif (kind == "mlp" or key == "generator") and not torch.equal(
            got[key], want[key]
        ):
            raise AssertionError(f"{kind}: captured {key} != eager")
    if worst > atol:
        raise AssertionError(f"{kind}: captured params differ from eager by "
                             f"{worst}, budget {atol}")
    what = ("params, Adam state, step, env carry, metrics and generator "
            "bitwise" if kind == "mlp" else
            f"params within {worst:.3g} (budget {atol:.3g}), generator "
            "bitwise")
    print(f"[capture] {kind} M={m}: {iterations} iterations captured == "
          f"eager: {what} ({updates} optimizer steps)")


def poisoned_health_run():
    """The ring/MLP at M=64 with ``fused_chunk=2 health=true
    recovery=true``: one ``_poison_carry(nan)`` before the third chunk. The
    health word skips the poisoned iterations, the ladder rolls back to the
    last good checkpoint, and the run ends on finite parameters with a
    rollback in ``recovery.jsonl``."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.train.recovery import (
        read_recovery_log,
    )

    name = "smoke_health"
    shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    trainer = cli.build_trainer([
        f"name={name}", "device=cuda", "num_formation=64",
        "total_timesteps=32000", "fused_chunk=2", "health=true",
        "recovery=true", "keep_last_n=3",
    ])
    run_chunk = trainer.run_chunk
    chunks = []

    def poisoned():
        if len(chunks) == 2:
            trainer._poison_carry(float("nan"))
        chunks.append(1)
        return run_chunk()

    trainer.run_chunk = poisoned
    trainer.train()
    del trainer.run_chunk
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.model.parameters())
    events = read_recovery_log(Path(trainer.log_dir) / "recovery.jsonl")
    kinds = [e["event"] for e in events]
    if not finite or "rollback" not in kinds or trainer.halted:
        raise AssertionError(f"health run: finite {finite}, halted "
                             f"{trainer.halted}, recovery events {kinds}")
    print(f"[health] MLP M=64 fused_chunk=2, NaN poison before chunk 3: "
          f"ends finite at {trainer.num_timesteps} steps; recovery.jsonl "
          f"{kinds}")


def train_phase():
    """Phase 5; returns the training paths' launch counts."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    trainer, rewards, got, captured_s = train_run(
        "smoke_gnn100", GNN100 + ("fused_chunk=10",),
        "gnn100 M=1024 N=100 fused_chunk=10")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"gnn100 launches {got}, want fused {want}")
    launches = {"knn_fused": got["knn_fused"]}
    print("[learn] gnn100 reward by iteration, port (TPU record): " + ", ".join(
        f"{i}: {rewards[i - 1]:.2f} ({tpu})"
        for i, tpu in TPU_GNN100_CURVE.items() if i <= len(rewards)))
    _, last3 = learning_check(rewards, "gnn100", LEARN_MARGIN)
    if not last3 > 0:
        raise AssertionError(f"gnn100: last-3 mean {last3:.3f} is not > 0")
    ckpt = latest_checkpoint(trainer.log_dir)
    res = evaluate_cli.main([
        f"checkpoint={ckpt}", "obs_mode=knn", "policy=gnn",
        "num_agents_per_formation=100", "eval_formations=1024",
        "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    if not ret["policy"] > ret["baseline"] > ret["zero"]:
        raise AssertionError(f"gnn100 ranking learned > baseline > zero "
                             f"fails: {ret}")
    print(f"[gnn100] learned {ret['policy']:.2f} > baseline "
          f"{ret['baseline']:.2f} > zero {ret['zero']:.2f} (M=1024)")
    rollout_graph_equals_plain(trainer.model, 100, 1024)
    profile_window(lambda: trainer._dispatch(1), "train gnn100 M=1024 N=100, "
                   "one captured iteration", 1, "iteration")
    elapsed("gnn100 captured")

    *_, eager_s = train_run(
        "smoke_gnn100_eager",
        GNN100[:-1] + ("total_timesteps=3072000",),
        "gnn100 M=1024 N=100, 3 iterations", capture=False)
    print(f"[capture] gnn100: captured {captured_s:.4f} s/iteration, eager "
          f"{eager_s:.4f} s/iteration, {eager_s / captured_s:.2f}x")
    elapsed("gnn100 eager")

    trainer, rewards, got, _ = train_run("smoke_gnn1024", GNN1024,
                                         "gnn1024 M=8 N=1024")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": 0, "knn_tiled": want}:
        raise AssertionError(f"gnn1024 launches {got}, want tiled {want}")
    launches["knn_tiled"] = got["knn_tiled"]
    learning_check(rewards, "gnn1024", 0.0)
    rollout_graph_equals_plain(trainer.model, 1024, 8)
    profile_window(trainer.run_iteration, "train gnn1024 M=8 N=1024, one "
                   "captured iteration", 1, "iteration")

    trainer, *_, captured_s = train_run(
        "smoke_mlp", MLP_DEFAULT, "ring/MLP default M=1000 N=5")
    elapsed("gnn1024 captured, ring/MLP captured")
    profile_window(trainer.run_iteration, "train ring/MLP default, one "
                   "captured iteration", 1, "iteration")
    elapsed("ring/MLP profile")
    *_, eager_s = train_run(
        "smoke_mlp_eager", ("total_timesteps=50000",),
        "ring/MLP default M=1000 N=5, 1 iteration", capture=False)
    print(f"[capture] ring/MLP default: captured {captured_s:.4f} "
          f"s/iteration, eager {eager_s:.4f} s/iteration, "
          f"{eager_s / captured_s:.2f}x")

    elapsed("ring/MLP eager")
    captured_equals_eager("mlp")
    captured_equals_eager("gnn")
    poisoned_health_run()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.env.types import EnvParams
    from marl_distributedformation_tpu_torch.models import GNNActorCritic
    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda

    dev = resolve_device("cuda")
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # Phase 1: build.
    t0 = time.perf_counter()
    _build.build([knn_cuda.SOURCE])
    print(f"[build] {knn_cuda.SOURCE}.cu in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log(knn_cuda.SOURCE).splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")

    elapsed("phase 1, build")

    # Phase 2: each kernel against its plain version, at the shape of the
    # training path that launches it and at the eval path's.
    shapes = {
        "knn_fused": (knn_cuda.knn_fused, 200,
                      {"train": (1024, 100, 4), "eval": (4096, 100, 4)}),
        "knn_tiled": (knn_cuda.knn_tiled, 50,
                      {"train": (8, 1024, 4), "eval": (512, 1024, 4)}),
    }
    stats = {
        name: {path: check_kernel(name, fn, *shape, reps)
               for path, shape in by_path.items()}
        for name, (fn, reps, by_path) in shapes.items()
    }

    elapsed("phase 2, kernels")

    # Phase 3: the k-NN swarm evaluation at full width.
    gen = torch.Generator().manual_seed(0)
    gnn = GNNActorCritic(k=4, generator=gen).to(dev).eval()
    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    # 101 steps: at T <= 100 the JAX package's last-100 window starts below 0
    # and wraps (eval.py:119); the port keeps that for parity.
    p1024 = EnvParams(num_agents=1024, obs_mode="knn", knn_k=4, max_steps=99)
    eval_launches = {}
    got, T = run_swarm(gnn, p100, 4096, "gnn knn N=100")
    if got != {"knn_fused": T + 1, "knn_tiled": 0}:
        raise AssertionError(f"N=100 launches {got}, want fused {T + 1}")
    eval_launches["knn_fused"] = got["knn_fused"]
    got, T = run_swarm(gnn, p1024, 512, "gnn knn N=1024")
    if got != {"knn_fused": 0, "knn_tiled": T + 1}:
        raise AssertionError(f"N=1024 launches {got}, want tiled {T + 1}")
    eval_launches["knn_tiled"] = got["knn_tiled"]
    profile_breakdown(gnn, p100, 4096)
    profile_breakdown(gnn, p1024, 512)
    kernel_equals_plain_end_to_end(gnn, p100, 32)
    kernel_equals_plain_end_to_end(gnn, p1024.replace(max_steps=18), 4)

    elapsed("phase 3, k-NN swarm evaluation")

    # Phase 4: the committed MLP checkpoint through the evaluate CLI.
    res = evaluate_cli.main([
        f"checkpoint={CKPT}", "eval_formations=4096", "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    if not ret["policy"] > ret["baseline"] > ret["zero"]:
        raise AssertionError(f"ranking learned > baseline > zero fails: {ret}")
    print(f"[mlp] learned {ret['policy']:.2f} > baseline "
          f"{ret['baseline']:.2f} > zero {ret['zero']:.2f}")

    elapsed("phase 4, committed checkpoint")

    # Phase 5: training through the kernels, this slice's main paths.
    launches = train_phase()
    elapsed("phase 5, training")

    replaces = {
        "knn_fused": "marl_distributedformation_tpu/ops/knn_pallas.py:117",
        "knn_tiled": "marl_distributedformation_tpu/ops/knn_pallas.py:155",
    }
    paths = {"knn_fused": "train gnn100", "knn_tiled": "train gnn1024"}
    # The launches and timings of the training path that launches each
    # kernel (this slice's main path); those of phase 3's eval under "eval".
    kernels = [
        {"name": name, "route": "cuda",
         "source": "marl_distributedformation_tpu_torch/csrc/knn.cu",
         "replaces": replaces[name], "path": paths[name],
         "launches": launches[name], **stats[name]["train"],
         "library_ms": None,
         "eval": {"launches": eval_launches[name], **stats[name]["eval"]}}
        for name in ("knn_fused", "knn_tiled")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
