#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``marl_distributedformation_tpu_torch/csrc`` with ``nvcc``.
2. Hold each k-NN kernel against its plain PyTorch version on the card, at
   the shapes each path gives it — fused: training (M=1024, N=100, k=4),
   eval and populations (M=4096), the matrix (M=256), the falsifier
   search (M=1600 and 3904); tiled: training (M=8, N=1024, k=4), eval
   (M=512), populations (M=16) and the matrix (M=32) — and on lattice, duplicate and edge-clipped points (exact ties) and
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
     captured and 1 eager; its profile covers the rollout and the first of
     the 10 epochs.
   - for every run: seconds an iteration split into rollout and update
     (CUDA events between graph replays), formation-steps/s,
     agent-transitions/s, peak memory (and above what earlier phases
     hold), each graph's nodes and capture time, and the device's busy
     share over one profiled captured iteration: the union of the device
     intervals in the trace over the wall time, asserted <= 100%, with the
     kernels' summed time beside it as a sum.
   - a 10-step rollout of each trained GNN at its training shape (N=100,
     M=1024; N=1024, M=8), captured through the kernel, against an eager
     rollout through the plain k-NN from one generator state: bitwise.
   - captured against eager training from one seed: the ring/MLP (M=64)
     bitwise after 3 iterations; the GNN (N=100, M=64) within the Adam
     budget (its gather's backward adds with atomics).
   - a ``health=true recovery=true`` run poisoned with NaN once: it must
     end on finite parameters with a rollback in ``recovery.jsonl``.
6. Train populations (``train/sweep.py``) through the ``train`` CLI, every
   member's formations folded into one env batch, the iteration captured:
   - ``pop4``: ``gnn100``'s command with ``num_seeds=4`` (30 iterations,
     ``fused_chunk=10``): ``knn_fused`` must launch 1 + 30 x 10 times (one
     launch a step for the whole population, at (4096,100,4)); the
     population mean of the last 3 iterations must beat the first 3 by 20
     and the best member end above 0; member 0's reward an iteration is
     printed beside phase 5's ``gnn100`` (the same seed), and iteration 1,
     before any update, must agree within ``ITER1_RTOL``; its s/iteration
     is set against 4 x ``gnn100``'s; the evaluate CLI's sweep mode (M=1024,
     full episode) must rank best member > baseline > zero.
   - ``pop1024`` (``gnn1024``'s command, 2 members, 4 iterations):
     ``knn_tiled`` must launch 1 + 4 x 10 times.
   - a 10-step population rollout at each shape, captured through the
     kernel with the K generators registered, against an eager rollout
     through the plain k-NN from the same states: bitwise.
   - ``sweep8``, the published population command
     (``docs/acceptance/sweep8``, 200 iterations, K=8, ring/MLP, M=16,
     N=3): the population mean over iterations 151-200 must beat 1-25 by
     5, with the 25-iteration windows printed beside the TPU's record; the
     best member must beat the baseline on 1024 held-out formations.
   - a ring/MLP lr sweep (K=4, M=64, 3 iterations): each member keeps its
     rate, the first update's step grows with the rate, and a run resumed
     from its anchor equals the uninterrupted one bitwise.
   - a population (K=2, M=64) captured against eager: the MLP bitwise, the
     GNN within the Adam budget.
7. CTDE and the heterogeneous curriculum through the ``train`` CLI:
   - ``ctde20``, ``docs/acceptance/ctde20``'s command at full depth (25
     iterations): the last 3 iterations beat the first 3 by 20 and end
     above 0 (the curve printed beside the TPU v5e record); its checkpoint
     through the evaluate CLI (M=64, full episodes) ranks learned >
     baseline > zero.
   - ``ctde_knn``: the CTDE actor on k-NN observations at N=100, M=1024, 3
     iterations: ``knn_fused`` must launch 1 + 3 x 10 times by replay.
   - ``hetero5``, ``docs/acceptance/hetero5``'s K=4 command at full depth
     (200 iterations, 4 stages): in each of stages 0-2 the population mean
     of the last 5 iterations beats the first 5 by 10 (stage 3 printed);
     the captured graphs are the same 3 after the last stage as after the
     first; the evaluate CLI's sweep mode on the README's three rows (N=5,
     N=20, N=20 with 4 obstacles; M=512, seed 1234, deterministic): the
     best member and the baseline beat zero in every row, every member
     printed beside the CPU record's ranking.
   - ``hetero_ctde``: ``policy=ctde`` over a 2-stage curriculum, M=64,
     ``preset=tpu``: finite losses, padded agents' values exactly 0.
   - captured against eager across a stage boundary (M=64, N_max=20): the
     MLP and CTDE single runs bitwise; a K=2 population with
     ``fused_chunk=2`` against the host loop bitwise; a population resumed
     from a mid-stage anchor against the uninterrupted run bitwise.
8. Scenarios (``scenarios/``: disturbance layers around the env step):
   - severity 0 is the clean env on the card: phase 5's ``gnn100`` policy
     at N=100, M=1024, 50 steps through a reset and ``knn_fused``; every
     registered scenario at severity 0 equals the clean run bitwise
     (states, observations, rewards), the obstacle scenarios also with 4
     obstacles; at severity 1 every scenario but ``clean`` differs (the
     obstacle ones with obstacles, and are bitwise clean without).
   - ``scen100``: ``gnn100``'s command (30 iterations, ``fused_chunk=10``)
     under a 3-stage schedule (12 clean, 12 of wind / sensor noise /
     actuator faults at 0.5, 6 of storm ramping 0.5 to 1.0), the stage
     changes at iterations 12 and 24 inside chunks: the records'
     ``scenario_severity`` is the schedule's every iteration; the 3
     captured graphs hold across both changes; iteration 1's reward equals
     ``gnn100``'s to the last digit (same seed, clean stage); iterations
     10-12 beat the first 3 by 20; ``knn_fused`` 1 + 30 x 10 launches by
     replay; s/iteration per stage beside ``gnn100``'s.
   - evaluation under ``wind`` and ``storm`` at 0.5 (M=4096, N=100, full
     episodes) through the evaluate CLI on ``scen100``'s checkpoint:
     learned > zero; ``gnn100``'s checkpoint's policy row beside it (not
     gated); eval formation-steps/s under ``storm`` against clean.
   - captured == eager across a stage boundary and a severity ramp
     (ring/MLP, M=64) bitwise; ``fused_chunk=2`` == the host loop with the
     stage change inside a chunk, records included; resumed mid-stage ==
     uninterrupted, bitwise.
9. The robustness matrix, the falsifier search and pursuit-evasion
   (``scenarios/matrix.py``, ``scenarios/adversary.py``, ``envs/pursuit.py``):
   - ``matrix100``: the robustness-matrix CLI in-process on ``gnn100``'s
     and ``scen100``'s checkpoints, ``clean``, ``wind``, ``storm``,
     ``sensor_noise``, ``comm_dropout`` x severities 0, 0.5, 1.0 at M=256,
     full episodes (30 cells): one build (the eval step captured once),
     ``knn_fused`` 30 x 1003 launches by replay, every severity-0 cell
     bitwise its checkpoint's clean cell, the ``wind`` 0.5 cell against
     the eager ``eval.evaluate_scenario`` within rtol 1e-5; s a cell
     captured beside the eager evaluation's; ``storm`` 1.0 of both.
   - ``matrix1024``: the same on ``gnn1024``'s checkpoint (``clean``,
     ``storm`` x 0, 1.0 at M=32) through ``knn_tiled``, 4 x 1003 launches.
   - ``adversary100``: the falsifier-search CLI on both checkpoints (4
     families, grid 6, 4 generations, M=64: P=25, 1600 formations), one
     build across both; every falsifier and the highest safe probe below
     it re-evaluated through ``AdversarySearch.evaluate_cells`` (drop
     above the tolerance, and at most it); candidates/s. Then one
     generation of the default population (10 families, P=61, 3904
     formations): every severity-0 row bitwise the clean row.
   - ``chase100``: ``gnn100``'s command on ``env=pursuit_evasion`` (20
     captured iterations, ``fused_chunk=10``, ``knn_fused`` 201 launches
     by replay) and a control run of it with ``learning_rate=0``: finite
     records, the same first iteration, the last 3 iterations' mean
     reward above the control's over the same episode steps (every
     formation starts its episode at once, so the reward also follows the
     pursuer closing in); at M=1024 over full episodes the learned policy
     with its noise > the seeded policy with its noise and > zero (the
     mean action printed, not gated); every scenario at severity 0 equals
     clean pursuit bitwise (M=1024, 50 steps) and ``moving_goal`` at 0.5
     differs; s/iteration beside ``gnn100``'s.
10. Serving (``serving/``: the bucketed engine, one CUDA graph a rung,
   the micro-batch scheduler, the hot-reload registry), ladder
   1/8/64/512:
   - the committed MLP checkpoint on flat ring rows, a seeded-init MLP and
     ``gnn100``'s checkpoint (N=100, k=4) on real k-NN request rows of
     (100, 20): env states at M=1024 through ``compute_obs_knn`` and
     ``knn_fused`` (2 launches); at every rung the captured rung equals
     the eager one bitwise and ``LoadedPolicy.predict`` within rtol 1e-5,
     atol 1e-6, also on a request of 3 chunks; two stochastic dispatches
     differ; the seeded MLP's bf16 ladder is within
     ``tests/bf16_budget.py``'s budget of the f32 one (the trained
     checkpoints' bf16 divergences printed); each rung's replay, ``act``
     and eager ``act`` times, the top rung's copy in.
   - a mixed stream over every rung (4 client threads, 48 requests) with
     a hot swap from ``gnn100`` to ``scen100`` (its checkpoint copied into
     the served directory under a larger step): every request answered,
     one capture a rung and the same graphs, ``model_step`` never
     decreasing in completion order, actions after the swap equal
     ``scen100``'s ``predict``.
   - ``run_smoke_benchmark`` on the ``gnn100`` scheduler (sizes 1-100
     formations, 4 clients, 3 s): requests/s, rows/s, agent-rows/s,
     p50/p95/p99, occupancy; the device's busy share over a profiled
     smoke; ``max_rate_at_slo`` at a 50 ms p95.
11. Print the kernels' JSON line (launches and timings at the training
   paths' shapes, those of the eval paths under ``eval``, the population
   paths' under ``population``, ``ctde_knn``'s launches under
   ``ctde_knn``, ``scen100``'s under ``scenario``, phase 9's under
   ``matrix``, ``adversary``, ``population61`` and ``chase``, and phase
   10's request rows under ``serving``), the card line, and the last line
   ``{"ok": true, "device": {...}}``.

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
    the last ``reps`` of ``reps + 1`` calls of ``fn`` under
    ``torch.profiler``: the kernel's own time. The first call inside the
    trace is not counted, since the trace may drop the first activity it
    sees (one run recorded 199 of 200); at least ``reps`` launches must be
    traced. CUDA events around back-to-back calls measure the host's launch
    path instead (allocation, checks, ctypes) when it is slower than the
    kernel, as it is for ``knn_fused`` on a slow host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launches = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name
    )
    if len(launches) < reps:
        raise AssertionError(f"{key}: {len(launches)} profiled launches, "
                             f"want at least {reps}")
    return sum(b - a for a, b in launches[-reps:]) / reps / 1e3


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


def busy_union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: the time the
    device had at least one kernel (or copy) running, each instant counted
    once however many ran in it."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile_window(run, label, per, unit, top=8):
    """Device time by kernel over one call of ``run`` (warmed up by the
    caller) under ``torch.profiler``, and the device's busy share of the
    window's wall time: the union of the device events' intervals in the
    trace (kernels that overlap count once), which must not exceed the
    wall time; the sum of the kernels' times is printed beside it, as a
    sum. Profiling slows the host, so the share may read low. Prints the
    ``top`` kernels and every k-NN kernel, in ms per ``unit`` (``per`` of
    them in the window); returns the busy share in percent (None when the
    trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    cuda = torch.autograd.DeviceType.CUDA
    union = busy_union_us(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == cuda and e.time_range.end > e.time_range.start
    )
    # Only the kernels themselves: an operator's row also carries the
    # device time of the kernels it launched, which would count them twice.
    events = [
        e for e in prof.key_averages()
        if e.device_type == cuda and device_us(e) > 0
    ]
    total = sum(device_us(e) for e in events)
    if total == 0 or union == 0:
        print(f"[profile] {label}: no device time in the trace (not measured)")
        return None
    share = 100 * union / wall_us
    if union > wall_us:
        raise AssertionError(f"{label}: device busy {union:.1f} us, the "
                             f"union of its intervals, exceeds the window's "
                             f"{wall_us:.1f} us")
    launches = sum(e.count for e in events)
    print(f"[profile] {label}: device busy {union / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({share:.1f}%, the union of the "
          f"device intervals); sum of kernel times {total / 1e3:.3f} ms "
          f"({100 * total / wall_us:.1f}% of wall, a sum, not a share); "
          f"{union / per / 1e3:.4f} ms busy/{unit}, {launches / per:.0f} "
          f"kernel launches/{unit}")
    # The k-NN kernels always, on the run's own positions, even when they
    # fall outside the top.
    ranked = sorted(events, key=device_us, reverse=True)
    shown = ranked[:top] + [e for e in ranked[top:] if "knn_" in e.key]
    for e in shown:
        print(f"[profile]   {device_us(e) / total * 100:5.1f}%  "
              f"{device_us(e) / per / 1e3:8.4f} ms/{unit}  x{e.count // per:<5d} "
              f"{e.key[:90]}")
    return share


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


def train_run(name, overrides, label, capture=True, before_train=None):
    """One run of the port's ``train`` CLI on the card (``build_trainer``
    then ``Trainer.train``, as its ``main`` runs them), the launch counts
    set to 0 just before it and read just after; ``capture=False`` runs the
    iteration eagerly; ``before_train(trainer)`` is called between the two.
    Prints the time an iteration (the warm-up and capture iterations left
    out of the steady split), throughput (for a curriculum also its active
    agent-transitions, averaged over the run's stages), peak memory and the
    graphs' sizes; returns ``(trainer, rewards an iteration, launches,
    steady s/iteration)``."""
    import shutil

    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.train import cli

    shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    trainer = cli.build_trainer([f"name={name}", "device=cuda", *overrides],
                                capture=capture)
    events = record_phases(trainer)
    if before_train is not None:
        before_train(trainer)
    member_rows = []
    if hasattr(trainer, "num_seeds"):
        # A population's records hold member means: keep each dispatch's
        # per-member rows (a device copy queued behind it, no sync).
        dispatch = trainer._dispatch

        def keep_rows(rollouts):
            chunk = dispatch(rollouts)
            member_rows.append(chunk.rows.clone())
            return chunk

        trainer._dispatch = keep_rows
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    trainer.phase_hook = None
    if member_rows:
        del trainer._dispatch
        rows = torch.cat(member_rows).cpu()
        # (iterations, K): each member's reward an iteration.
        trainer.smoke_member_rewards = rows[
            ..., trainer.metric_names.index("reward")].numpy()
    lines = (Path(trainer.log_dir) / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    trainer.smoke_records = records
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{label}: non-finite metrics {r}")
    iters = len(events)
    if len(records) != iters:
        raise AssertionError(f"{label}: {len(records)} records of {iters} "
                             "iterations")
    phase_ms = [(e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))
                for e in events]
    trainer.smoke_phase_ms = phase_ms
    phases = phase_ms[WARM_ITERATIONS[capture]:] or phase_ms
    roll, upd = mean(p[0] for p in phases), mean(p[1] for p in phases)
    s_iter = (roll + upd) / 1e3
    m = trainer.config.num_formations
    n = trainer.env_params.num_agents
    k = getattr(trainer, "num_seeds", 1)  # a population's members
    rate = trainer.ppo.n_steps * m * k / s_iter
    steps_per_iter = trainer.step // iters
    graphs = "; ".join(
        f"{g['phase']} {g['nodes']} nodes, captured in "
        f"{g['capture_s']:.3f} s, {g['calls']} calls"
        for g in trainer.graph_stats() if g["capture_s"] is not None
    ) or "none (eager)"
    per_member = (f" (population of {k}; per member {rate / k:.1f} "
                  f"formation-steps/s, {rate * n / k:.1f} "
                  "agent-transitions/s)") if k > 1 else ""
    if hasattr(trainer, "curriculum"):
        # Active agent-transitions of the whole run, over its steady time.
        active = float(np.sum(getattr(trainer, "num_timesteps_members",
                                      trainer.num_timesteps)))
        per_s = active / iters / s_iter
        per_member += (f"; active agent-transitions/s {per_s:.1f} (padded "
                       f"to N_max={n}; per member {per_s / k:.1f})")
    print(f"[train] {label} ({'captured' if capture else 'eager'}): {iters} "
          f"iterations in {wall:.2f} s ({wall / iters:.3f} s each with "
          f"start-up, capture and saves); steady {s_iter:.4f} s/iteration = "
          f"rollout+GAE {roll / 1e3:.4f} + update {upd / 1e3:.4f} "
          f"({steps_per_iter} optimizer steps, "
          f"{steps_per_iter / (upd / 1e3):.1f}/s); {rate:.1f} "
          f"formation-steps/s, {rate * n:.1f} agent-transitions/s"
          f"{per_member} (metrics.jsonl: "
          f"{records[-1]['env_steps_per_sec']:.1f}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
          f"above the {held / 2**30:.2f} GiB held before the run; launches "
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
    captured, replayed from the generators' states at capture) against an
    eager rollout through the plain k-NN from the same states: bitwise
    equal. A population (``PopulationModel``) rolls its K members' M
    formations each, folded into one batch, from K generators. The
    kernel's launches count by replay."""
    import torch

    from marl_distributedformation_tpu_torch.algo import collect_rollout
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        compute_obs,
        reset_batch,
    )
    from marl_distributedformation_tpu_torch.models.population import (
        PopulationModel,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

    dev = torch.device("cuda")
    k = getattr(model, "num_members", None)
    runs = {}
    for impl in ("auto", "torch"):
        params = EnvParams(num_agents=n, obs_mode="knn", knn_k=4,
                           knn_impl=impl)
        gens = [torch.Generator(device=dev).manual_seed(17 + i)
                for i in range(k or 1)]
        streams = gens if k else gens[0]
        state = reset_batch(params, (k or 1) * m, streams, dev)
        obs = compute_obs(state.agents, state.goal, params)
        start = [g.get_state() for g in gens]
        out = []

        forward = PopulationModel.rollout_forward if k else None

        def rollout():
            out[:] = collect_rollout(model, state, obs, streams, params, 10,
                                     forward=forward)

        if impl == "auto":
            knn_cuda.reset_launches()
            graph = PhaseGraph("rollout", rollout, gens)
            graph()  # the warm-up, eager
            for g, s in zip(gens, start):
                g.set_state(s)
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
    who = f"K={k} x M={m}" if k else f"M={m}"
    print(f"[rollout] N={n} {who}, 10 steps: captured graph through the "
          f"kernel == eager plain path bitwise (obs, actions, log_probs, "
          f"values, rewards); {graph.nodes} nodes; launches {launches}")


def _carry(trainer):
    """The trainer's state as tensors: parameters, Adam state, step, env
    carry, the metrics ring and the generators (a population's K)."""
    import torch

    it = trainer._iteration
    gens = getattr(trainer, "generators", None) or [trainer.generator]
    return {
        **{f"param {k}": p.detach().clone()
           for k, p in trainer.model.named_parameters()},
        **{f"mu {k}": v.clone() for k, v in trainer.opt_state.mu.items()},
        **{f"nu {k}": v.clone() for k, v in trainer.opt_state.nu.items()},
        "count": trainer.opt_state.count.clone(), "step": it.step.clone(),
        "agents": it.env.agents.clone(), "obs": it.obs.clone(),
        "metrics": it.ring.buf.clone(),
        "generator": torch.stack([g.get_state() for g in gens]),
    }


def captured_equals_eager(kind, iterations=3, members=None):
    """Two trainers from one seed on the card, one captured and one eager,
    ``iterations`` iterations each (the last fully replayed): the MLP's
    parameters, Adam state, step, env carry, metrics and generator bitwise
    equal; the GNN's parameters within ``tests/adam_budget.py``'s budget
    (``lr`` a step: the gather's backward adds with atomics, so two GNN
    updates on the card are not bitwise), its generator equal. With
    ``members`` K, two populations of K (members from seeds 3, 4, ...),
    every member's state and generator held the same way."""
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
    from marl_distributedformation_tpu_torch.train.sweep import SweepTrainer

    if kind == "mlp":
        params, m, ppo = EnvParams(), 64, PPOConfig()
    else:
        params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
        m, ppo = 64, PPOConfig(batch_size=16384)

    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        return (MLPActorCritic(params.obs_dim, generator=gen)
                if kind == "mlp" else GNNActorCritic(k=4, generator=gen))

    carries = {}
    for capture in (True, False):
        config = TrainConfig(num_formations=m, seed=3, checkpoint=False,
                             log_dir=str(ROOT / "logs" / "smoke_compare"))
        if members:
            trainer = SweepTrainer(
                params, ppo, config, members,
                models=[make(3 + i) for i in range(members)],
                device="cuda", capture=capture,
            )
        else:
            trainer = Trainer(params, ppo, config, model=make(3),
                              device="cuda", capture=capture)
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
    who = f"K={members} x M={m}" if members else f"M={m}"
    print(f"[capture] {kind} {who}: {iterations} iterations captured == "
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
    """Phase 5; returns the training paths' launch counts and the captured
    ``gnn100`` run's rewards and s/iteration (phase 6 sets them beside its
    population's)."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    trainer, rewards, got, captured_s = train_run(
        "smoke_gnn100", GNN100 + ("fused_chunk=10",),
        "gnn100 M=1024 N=100 fused_chunk=10")
    gnn100 = {"rewards": rewards, "s_iter": captured_s,
              "model": trainer.model,
              "ckpt": latest_checkpoint(trainer.log_dir)}
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
    # Phase 9's matrix on N=1024 evaluates the run's checkpoint.
    gnn100["ckpt1024"] = (latest_checkpoint(trainer.log_dir)
                          or trainer.save())
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
    # Depth cut: its rollout and first epoch (781 of 7,810 replays of one
    # minibatch graph), not the whole iteration, whose 1.39 M traced
    # kernels took the profiler 116-177 s; the epochs replay one graph.
    rollout, minibatch, _ = trainer._phases
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs

    def first_epoch():
        rollout()
        for _ in range(steps):
            minibatch()

    profile_window(first_epoch, f"train ring/MLP default, the rollout and "
                   f"the first epoch ({steps} minibatch replays) of a "
                   "captured iteration", 1, "window")
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
    return launches, gnn100


# The published population command (docs/acceptance/sweep8/README.md) and
# its record, the TPU's (docs/acceptance/sweep8/REGRESSION.md: population
# mean reward in 25-iteration windows; eval_all_members_tpu.json).
SWEEP8 = ("num_seeds=8", "num_formation=16", "num_agents_per_formation=3",
          "strict_parity=false", "max_steps=64", "n_steps=16",
          "batch_size=192", "n_epochs=4", "total_timesteps=153600",
          "save_freq=3200", "use_wandb=false")
SWEEP8_ENV = ("num_agents_per_formation=3", "strict_parity=false",
              "max_steps=64")
TPU_SWEEP8_WINDOWS = {(1, 25): -47.3, (76, 100): -38.3, (126, 150): -37.1,
                      (151, 175): -36.7, (176, 200): -38.1}
SWEEP8_MARGIN = 5.0
POP4 = GNN100 + ("num_seeds=4", "fused_chunk=10")
# The N=1024 population: gnn1024's command, 2 members, 4 iterations.
POP1024 = GNN1024[:-1] + ("total_timesteps=327680", "num_seeds=2")
LR_SWEEP = ("num_formation=64", "num_seeds=4",
            "learning_rates=[1e-4,3e-4,1e-3,3e-3]")
# Member 0 of pop4 and the single gnn100 run share seed 0: iteration 1
# (before any update) differs only by the rounding of the members' batched
# matmuls, so its population-mean reward agrees to this relative tolerance.
ITER1_RTOL = 1e-3


def sweep_eval(name, env):
    """The evaluate CLI's sweep mode on the run's member directories
    (1024 held-out formations, seed 1234)."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli

    return evaluate_cli.main([f"name={name}", *env, "eval_formations=1024",
                              "eval_seed=1234", "device=cuda"])


def lr_sweep_check():
    """The ring/MLP lr sweep, 3 iterations: each member's rate is its own
    in the device ``lr``, the anchor and its member file; the first
    update's mean parameter step grows with the members' rates; and a run
    of 2 iterations resumed from its anchor for a third equals the run of
    3 bitwise (parameters, Adam state, steps, env carry, generators)."""
    import shutil

    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        latest_sweep_state,
        msgpack_restore_file,
    )

    per_iter = 64 * 5 * 10
    rates = np.float32([1e-4, 3e-4, 1e-3, 3e-3])
    for name in ("smoke_lr_full", "smoke_lr_part"):
        shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    full = cli.build_trainer(["name=smoke_lr_full", "device=cuda", *LR_SWEEP,
                              f"total_timesteps={3 * per_iter}"])
    before = {k: p.detach().clone() for k, p in full.model.params.items()}
    full.run_iteration()
    step = torch.stack([
        (full.model.params[k] - before[k]).abs().reshape(4, -1).mean(1)
        for k in before
    ]).mean(0).tolist()
    full.train()
    if not (step[0] < step[1] < step[2] < step[3]):
        raise AssertionError(f"lr sweep: mean first-update steps {step} do "
                             f"not grow with the rates {rates.tolist()}")
    got = full._iteration.lr.cpu().numpy()
    anchor = msgpack_restore_file(latest_sweep_state(full.log_dir))
    hyper = anchor["opt_state"]["1"]["hyperparams"]["learning_rate"]
    member = [msgpack_restore_file(latest_checkpoint(
        Path(full.log_dir) / f"seed{i}"))["learning_rate"] for i in range(4)]
    for what, value in (("device lr", got), ("anchor", anchor[
            "learning_rates"]), ("anchor opt_state", hyper),
            ("member files", np.float32(member))):
        if not np.array_equal(np.asarray(value, np.float32), rates):
            raise AssertionError(f"lr sweep: {what} rates {value}, want "
                                 f"{rates.tolist()}")
    part = cli.build_trainer(["name=smoke_lr_part", "device=cuda", *LR_SWEEP,
                              f"total_timesteps={2 * per_iter}"])
    part.train()
    resumed = cli.build_trainer(["name=smoke_lr_part", "device=cuda",
                                 *LR_SWEEP, f"total_timesteps={3 * per_iter}",
                                 "resume=true"])
    resumed.train()
    torch.cuda.synchronize()
    a, b = _carry(full), _carry(resumed)
    for key in a:
        if key != "metrics" and not torch.equal(a[key], b[key]):
            raise AssertionError(f"lr sweep: resumed {key} != the "
                                 "uninterrupted run's")
    print(f"[sweep] lr sweep ring/MLP K=4 M=64: rates "
          f"{[f'{x:g}' for x in rates]} in the device lr, the anchor and the "
          f"member files; mean first update {[f'{x:.3g}' for x in step]}; "
          f"resumed from the anchor at "
          f"{2 * per_iter} steps == uninterrupted at {3 * per_iter}, "
          "bitwise")


def population_phase(gnn100):
    """Phase 6, populations; returns their paths' launch counts."""
    import numpy as np

    trainer, rewards, got, pop_s = train_run(
        "smoke_pop4", POP4, "pop4 K=4 M=1024 N=100 fused_chunk=10")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"pop4 launches {got}, want fused {want}")
    launches = {"knn_fused": got["knn_fused"]}
    member0 = trainer.smoke_member_rewards[:, 0]
    single = gnn100["rewards"]
    print("[learn] pop4 member 0 (seed 0) reward by iteration beside the "
          "single gnn100 run of phase 5: " + ", ".join(
              f"{i + 1}: {a:.2f} ({b:.2f})"
              for i, (a, b) in enumerate(zip(member0, single))))
    if not abs(member0[0] - single[0]) <= ITER1_RTOL * abs(single[0]):
        raise AssertionError(f"pop4 member 0 iteration 1 {member0[0]} != "
                             f"gnn100 {single[0]} within rtol {ITER1_RTOL}")
    learning_check(rewards, "pop4 population mean", LEARN_MARGIN)
    best = float(trainer.smoke_member_rewards[-1].max())
    if not best > 0:
        raise AssertionError(f"pop4: best member ends at {best}, not > 0")
    print(f"[pop4] last iteration's member rewards "
          f"{np.round(trainer.smoke_member_rewards[-1], 3).tolist()}; "
          f"s/iteration {pop_s:.4f} against 4 x gnn100's "
          f"{gnn100['s_iter']:.4f}: ratio {pop_s / (4 * gnn100['s_iter']):.3f}")
    res = sweep_eval("smoke_pop4", ("obs_mode=knn", "policy=gnn",
                                    "num_agents_per_formation=100"))
    if not res["best_return"] > res["baseline_return"] > res["zero_return"]:
        raise AssertionError(f"pop4 ranking best > baseline > zero fails: "
                             f"{res}")
    print(f"[pop4] best member {res['best_member']} {res['best_return']:.2f} "
          f"> baseline {res['baseline_return']:.2f} > zero "
          f"{res['zero_return']:.2f} (M=1024)")
    rollout_graph_equals_plain(trainer.model, 100, 1024)
    profile_window(lambda: trainer._dispatch(1), "train pop4 K=4 M=1024 "
                   "N=100, one captured iteration", 1, "iteration")
    elapsed("pop4")

    trainer, rewards, got, _ = train_run("smoke_pop1024", POP1024,
                                         "pop1024 K=2 M=8 N=1024")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": 0, "knn_tiled": want}:
        raise AssertionError(f"pop1024 launches {got}, want tiled {want}")
    launches["knn_tiled"] = got["knn_tiled"]
    rollout_graph_equals_plain(trainer.model, 1024, 8)
    profile_window(trainer.run_iteration, "train pop1024 K=2 M=8 N=1024, "
                   "one captured iteration", 1, "iteration")
    elapsed("pop1024")

    trainer, rewards, *_ = train_run("smoke_sweep8", SWEEP8,
                                     "sweep8 K=8 ring/MLP M=16 N=3")
    if len(rewards) != 200:
        raise AssertionError(f"sweep8: {len(rewards)} iterations, want 200")
    windows = {w: float(np.mean(rewards[w[0] - 1:w[1]]))
               for w in TPU_SWEEP8_WINDOWS}
    print("[learn] sweep8 population mean reward by 25-iteration window, "
          "port (the TPU's record): " + ", ".join(
              f"{a}-{b}: {windows[(a, b)]:.2f} ({tpu})"
              for (a, b), tpu in TPU_SWEEP8_WINDOWS.items()))
    early, late = windows[(1, 25)], float(np.mean(rewards[150:200]))
    print(f"[learn] sweep8: iterations 1-25 {early:.3f}, 151-200 {late:.3f}")
    if not late >= early + SWEEP8_MARGIN:
        raise AssertionError(f"sweep8: 151-200 mean {late:.3f} does not "
                             f"beat 1-25 {early:.3f} by {SWEEP8_MARGIN}")
    res = sweep_eval("smoke_sweep8", SWEEP8_ENV)
    if not res["beats_baseline"]:
        raise AssertionError(f"sweep8: best member does not beat the "
                             f"baseline: {res}")
    tpu = json.loads((ROOT / "docs/acceptance/sweep8/"
                      "eval_all_members_tpu.json").read_text())
    print(f"[sweep8] best member {res['best_member']} {res['best_return']:.2f}"
          f" > baseline {res['baseline_return']:.2f} (zero "
          f"{res['zero_return']:.2f}); the TPU's record: best "
          f"{tpu['best_member']} {tpu['best_return']:.2f}, baseline "
          f"{tpu['baseline_return']:.2f}")
    profile_window(trainer.run_iteration, "train sweep8 K=8 M=16 N=3, one "
                   "captured iteration", 1, "iteration")
    elapsed("sweep8")

    lr_sweep_check()
    captured_equals_eager("mlp", members=2)
    captured_equals_eager("gnn", members=2)
    elapsed("lr sweep, population captured == eager")
    return launches


# The published CTDE command (docs/acceptance/ctde20: 25 iterations at the
# default budget) with its record, a TPU v5e's curve and a CPU eval of the
# TPU-trained checkpoint (M=64).
CTDE20 = ("policy=ctde", "num_agents_per_formation=20",
          "num_formation=2048", "preset=tpu")
TPU_CTDE20_CURVE = {1: -37.58, 5: -25.90, 10: -11.05, 15: 3.93, 20: 6.70,
                    25: 7.63}
CTDE20_EVAL_RECORD = {"policy": 2375, "baseline": -1058, "zero": -30630}
# The CTDE actor on k-NN observations (root train.py allows it), 3
# iterations through knn_fused.
CTDE_KNN = ("policy=ctde", "obs_mode=knn", "num_agents_per_formation=100",
            "num_formation=1024", "preset=tpu", "total_timesteps=3072000")
# docs/acceptance/hetero5/README.md's K=4 command, letter for letter, and
# its CPU record's files.
HETERO5 = (
    "num_seeds=4", "num_formation=64", "num_agents_per_formation=20",
    "preset=tpu", "total_timesteps=2560000", "ent_coef_final=0.0",
    "log_std_final=-2.5", "log_std_decay_start=0.5",
    "curriculum=[{rollouts: 30, agent_counts: [5]},\n"
    "             {rollouts: 40, agent_counts: [5, 5, 20]},\n"
    "             {rollouts: 30, agent_counts: [5, 5, 20], num_obstacles: 4},\n"
    "             {rollouts: 100, agent_counts: [5, 5, 20], num_obstacles: 4}]",
)
HETERO5_DOCS = ROOT / "docs/acceptance/hetero5"
HETERO5_EVAL_ROWS = {
    "n5": ("num_agents_per_formation=5",),
    "n20": ("num_agents_per_formation=20",),
    "n20_obs": ("num_agents_per_formation=20", "num_obstacles=4"),
}
STAGE_MARGIN = 10.0  # each of stages 0-2: last 5 iterations over first 5
HETERO_CTDE = (
    "policy=ctde", "num_formation=64", "num_agents_per_formation=20",
    "preset=tpu",
    "curriculum=[{rollouts: 3, agent_counts: [20]},"
    " {rollouts: 3, agent_counts: [5, 20], num_obstacles: 2}]",
)


def stage_windows(rewards, ends, width=5):
    """``{stage: (mean of its first width iterations, of its last)}``."""
    out, start = {}, 0
    for i, end in enumerate(ends):
        seg = rewards[start:end]
        out[i] = (mean(seg[:width]), mean(seg[-width:]))
        start = end
    return out


def ctde_phase():
    """Phase 7a, CTDE: ``ctde20`` at full depth, its evaluation, and
    ``ctde_knn`` through ``knn_fused``; returns ``ctde_knn``'s launches."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    trainer, rewards, got, _ = train_run("smoke_ctde20", CTDE20,
                                         "ctde20 M=2048 N=20")
    if len(rewards) != 25 or got != {"knn_fused": 0, "knn_tiled": 0}:
        raise AssertionError(f"ctde20: {len(rewards)} iterations, launches "
                             f"{got}; want 25 on ring observations")
    print("[learn] ctde20 reward by iteration, port (a TPU v5e's record, "
          "docs/acceptance/ctde20): " + ", ".join(
              f"{i}: {rewards[i - 1]:.2f} ({tpu})"
              for i, tpu in TPU_CTDE20_CURVE.items()))
    _, last3 = learning_check(rewards, "ctde20", LEARN_MARGIN)
    if not last3 > 0:
        raise AssertionError(f"ctde20: last-3 mean {last3:.3f} is not > 0")
    res = evaluate_cli.main([
        f"checkpoint={latest_checkpoint(trainer.log_dir)}", "policy=ctde",
        "num_agents_per_formation=20", "eval_formations=64", "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    if not ret["policy"] > ret["baseline"] > ret["zero"]:
        raise AssertionError(f"ctde20 ranking learned > baseline > zero "
                             f"fails: {ret}")
    print(f"[ctde20] learned {ret['policy']:.2f} > baseline "
          f"{ret['baseline']:.2f} > zero {ret['zero']:.2f} (M=64, full "
          "episodes); the record, a CPU eval of the TPU-trained checkpoint: "
          + " / ".join(str(v) for v in CTDE20_EVAL_RECORD.values()))
    profile_window(lambda: trainer._dispatch(1), "train ctde20 M=2048 N=20, "
                   "one captured iteration", 1, "iteration")
    elapsed("ctde20")

    trainer, rewards, got, _ = train_run("smoke_ctde_knn", CTDE_KNN,
                                         "ctde_knn M=1024 N=100")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if len(rewards) != 3 or got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"ctde_knn launches {got} over {len(rewards)} "
                             f"iterations, want fused {want} over 3")
    profile_window(lambda: trainer._dispatch(1), "train ctde_knn M=1024 "
                   "N=100, one captured iteration", 1, "iteration")
    elapsed("ctde_knn")
    return got["knn_fused"]


def hetero5_run():
    """``hetero5`` at full depth: each of stages 0-2 learns, the captured
    graphs are the same after the last stage as after the first, then the
    sweep-mode evaluation of its three rows."""
    graphs_at_stage = []

    def track(trainer):
        start = trainer.start_stage

        def tracked(stage):
            graphs_at_stage.append(trainer.graph_count())
            start(stage)

        trainer.start_stage = tracked

    trainer, rewards, got, _ = train_run(
        "smoke_hetero5", HETERO5, "hetero5 K=4 M=64 N_max=20",
        before_train=track)
    del trainer.start_stage
    ends = trainer.curriculum.stage_ends()
    if len(rewards) != ends[-1] or got != {"knn_fused": 0, "knn_tiled": 0}:
        raise AssertionError(f"hetero5: {len(rewards)} iterations, launches "
                             f"{got}; want {ends[-1]} on ring observations")
    final = trainer.graph_count()
    print(f"[graphs] hetero5: captured graphs at each stage's start "
          f"{graphs_at_stage}, after the last stage {final}")
    if not graphs_at_stage[1] == final == 3:
        raise AssertionError("hetero5: the graph count changed across "
                             f"stages: {graphs_at_stage} then {final}")
    record = [json.loads(line) for line in (
        HETERO5_DOCS / "metrics_fix_cpu.jsonl").read_text().splitlines()]
    cpu = stage_windows([r["reward"] for r in record], ends)
    port = stage_windows(rewards, ends)
    for stage, (first, last) in port.items():
        a, b = cpu[stage]
        print(f"[learn] hetero5 stage {stage} population mean reward, first "
              f"5 -> last 5 iterations: {first:.3f} -> {last:.3f} (the CPU "
              f"record's, metrics_fix_cpu.jsonl: {a:.3f} -> {b:.3f})"
              + ("" if stage < 3 else "; not gated"))
        if stage < 3 and not last >= first + STAGE_MARGIN:
            raise AssertionError(f"hetero5 stage {stage}: last-5 mean "
                                 f"{last:.3f} does not beat first-5 "
                                 f"{first:.3f} by {STAGE_MARGIN}")
    print(f"[hetero5] members' final rewards "
          f"{[round(float(x), 3) for x in trainer.smoke_member_rewards[-1]]}")
    profile_window(trainer.run_iteration, "train hetero5 K=4 M=64 N_max=20, "
                   "one iteration (host loop, captured phases)", 1,
                   "iteration")
    elapsed("hetero5 training")

    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli

    passes = None
    for row, env in HETERO5_EVAL_ROWS.items():
        res = evaluate_cli.main(["name=smoke_hetero5", *env,
                                 "eval_formations=512", "eval_seed=1234",
                                 "eval_deterministic=true", "device=cuda"])
        ref = json.loads((HETERO5_DOCS / f"eval_member_ranking_{row}.json")
                         .read_text())
        beat = {m for m, r in res["member_returns"].items()
                if r > res["baseline_return"]}
        passes = beat if passes is None else passes & beat
        print(f"[hetero5] eval {row} (M=512, seed 1234, deterministic): "
              + ", ".join(f"{m} {r:.1f}" for m, r in
                          res["member_returns"].items())
              + f"; baseline {res['baseline_return']:.1f}, zero "
              f"{res['zero_return']:.1f}; {len(beat)} of 4 beat the "
              "baseline. The CPU record's (eval_member_ranking_"
              f"{row}.json): " + ", ".join(
                  f"{m} {r:.1f}" for m, r in ref["member_returns"].items())
              + f"; baseline {ref['baseline_return']:.1f}")
        if not (res["best_return"] > res["zero_return"]
                and res["baseline_return"] > res["zero_return"]):
            raise AssertionError(f"hetero5 eval {row}: best member "
                                 f"{res['best_return']} and baseline "
                                 f"{res['baseline_return']} must beat zero "
                                 f"{res['zero_return']}")
    print(f"[hetero5] members beating the baseline in all three rows: "
          f"{sorted(passes)} ({len(passes)} of 4; the README expects about "
          "1 in 3 to 1 in 5 candidates to)")
    elapsed("hetero5 evaluation")


def _hetero_carry(trainer):
    carry = _carry(trainer)
    carry["n_agents"] = trainer.layout.n_agents.clone()
    return carry


def curriculum_captured_equals_eager():
    """Captured against eager across a stage boundary, at M=64, N_max=20:
    the single curriculum run of 3 iterations (the boundary after the
    second) for the MLP and the CTDE model, bitwise; the curriculum
    population (K=2, MLP) with ``fused_chunk=2`` against the host loop,
    bitwise; and a population resumed from an anchor two rollouts into
    a three-rollout stage against the uninterrupted run, bitwise."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import (
        CTDEActorCritic,
        MLPActorCritic,
    )
    from marl_distributedformation_tpu_torch.train import TrainConfig
    from marl_distributedformation_tpu_torch.train.curriculum import (
        Curriculum,
        CurriculumStage,
        HeteroTrainer,
    )
    from marl_distributedformation_tpu_torch.train.hetero_sweep import (
        HeteroSweepTrainer,
    )

    params = EnvParams(num_agents=20)
    base = ROOT / "logs" / "smoke_curriculum"
    shutil.rmtree(base, ignore_errors=True)

    def model(kind, seed):
        cls = CTDEActorCritic if kind == "ctde" else MLPActorCritic
        return cls(params.obs_dim, generator=torch.Generator().manual_seed(
            seed))

    def config(name, **kw):
        kw = {"num_formations": 64, "seed": 3, "checkpoint": False,
              "log_dir": str(base / name), **kw}
        return TrainConfig(**kw)

    def compare(a, b, what, skip=()):
        torch.cuda.synchronize()
        x, y = _hetero_carry(a), _hetero_carry(b)
        for key in x:
            if key not in skip and not torch.equal(x[key], y[key]):
                raise AssertionError(f"{what}: {key} differs")

    # 3 minibatches an epoch for both policies (CTDE's of 204 formations).
    ppo = PPOConfig(batch_size=4096)
    cur = Curriculum((CurriculumStage(2, (5, 20)),
                      CurriculumStage(1, (5, 20), num_obstacles=4)))
    for kind in ("mlp", "ctde"):
        runs = []
        for capture in (True, False):
            t = HeteroTrainer(cur, params, ppo,
                              config(f"{kind}{capture}"),
                              model=model(kind, 3), device="cuda",
                              capture=capture)
            t.train()
            runs.append(t)
        compare(*runs, f"curriculum {kind} captured vs eager")
        print(f"[capture] curriculum {kind} M=64 N_max=20, 3 iterations "
              f"across a stage boundary: captured == eager bitwise "
              f"(params, Adam state, step, env carry, counts, metrics, "
              f"generator; {runs[0].step} optimizer steps, "
              f"{runs[0].graph_count()} graphs)")

    cur = Curriculum((CurriculumStage(3, (5,)),
                      CurriculumStage(2, (5, 20), num_obstacles=4)))

    def sweep(name, **kw):
        return HeteroSweepTrainer(cur, params, ppo, config(name, **kw),
                                  2, models=[model("mlp", 3), model("mlp", 4)],
                                  device="cuda")

    host, fused = sweep("host"), sweep("fused", fused_chunk=2)
    host.train()
    fused.train()
    compare(host, fused, "curriculum population fused vs host loop",
            skip=("metrics",))
    records = [[{k: v for k, v in json.loads(line).items()
                 if k not in ("time", "env_steps_per_sec")}
                for line in (Path(t.log_dir) / "metrics.jsonl").read_text()
                .splitlines()] for t in (host, fused)]
    if records[0] != records[1]:
        raise AssertionError("curriculum population: fused records differ")
    kw = dict(checkpoint=True, save_freq=10**9)
    full = sweep("full", **kw)
    full.train()
    per_iter = 10 * 64 * 5  # one member's active transitions in stage 0
    sweep("part", total_timesteps=2 * per_iter, **kw).train()
    resumed = sweep("part", resume=True, **kw)
    if resumed.completed_rollouts != 2:
        raise AssertionError(f"resumed at rollout "
                             f"{resumed.completed_rollouts}, want 2")
    resumed.train()
    compare(full, resumed, "curriculum population resumed mid-stage")
    print("[capture] curriculum population K=2 M=64 N_max=20 (MLP): "
          "fused_chunk=2 (chunks 2, 1 | 2) == the host loop bitwise, records "
          "equal; resumed from the anchor at rollout 2 of stage 0's 3 == the "
          "uninterrupted run bitwise")


def curriculum_phase():
    """Phase 7b, the curriculum: ``hetero5``, ``hetero_ctde`` and the
    captured-against-eager checks across stage boundaries."""
    import torch

    from marl_distributedformation_tpu_torch.algo.rollout import (
        policy_forward,
    )

    hetero5_run()
    trainer, *_ = train_run("smoke_hetero_ctde", HETERO_CTDE,
                            "hetero_ctde K=1 M=64 N_max=20")
    layout = trainer.layout
    with torch.no_grad():
        _, _, value = policy_forward(trainer.model, trainer.obs, layout.fmask)
    padded = ~layout.mask
    if not bool(padded.any()) or not bool((value[padded] == 0).all()):
        raise AssertionError("hetero_ctde: padded agents' values are not 0")
    print(f"[hetero_ctde] losses finite over 6 iterations; the "
          f"{int(padded.sum())} padded agents' values are exactly 0")
    profile_window(trainer.run_iteration, "train hetero_ctde M=64 N_max=20, "
                   "one captured iteration", 1, "iteration")
    curriculum_captured_equals_eager()
    elapsed("curriculum captured == eager")


# gnn100's command under a 3-stage scenario schedule; the changes at
# iterations 12 and 24 fall inside the 10-iteration chunks.
SCEN100_SCHEDULE = (
    "scenarios=[{rollouts: 12, scenarios: [clean]}, {rollouts: 12, "
    "scenarios: [wind, sensor_noise, actuator_fault], severity: 0.5}, "
    "{rollouts: 6, scenarios: [storm], severity: 1.0}]")
SCEN100 = GNN100 + ("fused_chunk=10", SCEN100_SCHEDULE)
SCEN100_STAGES = ((0, 12), (12, 24), (24, 30))
SCENARIO_EVALS = ("wind", "storm")
IDENTITY_STEPS = 50


def scenario_roll(model, params, sp, m=1024):
    """``model`` acting on M formations for ``IDENTITY_STEPS`` steps on the
    card, through the clean step (``sp`` None) or the scenario step: each
    step's (agents, goal, obstacles, steps, obs, reward, done), with the
    k-NN launches checked (one a step and one at the reset)."""
    import torch

    from marl_distributedformation_tpu_torch.envs import spec_for_params
    from marl_distributedformation_tpu_torch.eval import policy_act_fn
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.scenarios import (
        ScenarioStreams,
        broadcast_params,
        init_scenario_state,
        scenario_step_batch,
    )

    dev = torch.device("cuda")
    env = spec_for_params(params)
    act = policy_act_fn(model, params)
    gen = torch.Generator(device=dev).manual_seed(11)
    streams = ScenarioStreams(torch.Generator(device=dev).manual_seed(12))
    knn_cuda.reset_launches()
    state, obs = env.reset_env(params, m, gen, dev)
    if sp is not None:
        state = init_scenario_state(state, params, streams)
        sp = broadcast_params(sp.to(dev), m)
    out = []
    with torch.no_grad():
        for _ in range(IDENTITY_STEPS):
            vel = act(state.agents, state.goal, state.obstacles, obs, None)
            if sp is None:
                state, tr = env.step_batch(state, vel, params, gen)
            else:
                state, tr = scenario_step_batch(state, vel, sp, params, gen,
                                                streams)
            obs = tr.obs
            out.append((state.agents, state.goal, state.obstacles,
                        state.steps, tr.obs, tr.reward, tr.done))
    torch.cuda.synchronize()
    launches = dict(knn_cuda.LAUNCHES)
    if launches != {"knn_fused": IDENTITY_STEPS + 1, "knn_tiled": 0}:
        raise AssertionError(f"identity run launches {launches}")
    return out


def rolls_equal(a, b):
    import torch

    return all(torch.equal(x, y) for sa, sb in zip(a, b)
               for x, y in zip(sa, sb))


def scenario_identity(model):
    """Severity 0 on the card: phase 5's policy acting on M=1024 formations
    of N=100 through the knn step (``knn_fused``) for 50 steps, through a
    reset (max_steps 40); every registered scenario at severity 0 equals
    the clean run bitwise, and at severity 1 every one but ``clean``
    differs; the obstacle scenarios with 4 obstacles, and bitwise clean
    without."""
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.scenarios import (
        registered_scenarios,
        scenario_params_for,
    )

    m = 1024
    t0 = time.perf_counter()
    names = [n for n in registered_scenarios() if not n.startswith("adv:")]
    checked = []
    for obstacles in (0, 4):
        params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4,
                           max_steps=40, num_obstacles=obstacles)
        clean = scenario_roll(model, params, None, m)
        if int(sum(int(s[6].sum()) for s in clean)) != m:
            raise AssertionError("identity run: every formation must reset")
        for name in names:
            if obstacles and name not in ("clean", "obstacle_field",
                                          "moving_obstacles"):
                continue
            if not rolls_equal(clean, scenario_roll(
                    model, params, scenario_params_for(name, 0.0), m)):
                raise AssertionError(f"{name} at severity 0 differs from the "
                                     f"clean run ({obstacles} obstacles)")
            if name == "clean":
                continue
            obstacle_layer = name in ("obstacle_field", "moving_obstacles")
            same = rolls_equal(clean, scenario_roll(
                model, params, scenario_params_for(name, 1.0), m))
            if same != (obstacle_layer and not obstacles):
                raise AssertionError(f"{name} at severity 1 with {obstacles} "
                                     f"obstacles: equal to clean is {same}")
            checked.append(f"{name}{'+obs' if obstacles else ''}")
        del clean
    print(f"[scenario] severity 0 == clean bitwise (states, obs, rewards) "
          f"for {len(names)} scenarios at N=100 M={m}, {IDENTITY_STEPS} "
          f"steps through a reset, knn_fused {IDENTITY_STEPS + 1} launches a "
          f"run; the obstacle scenarios also with 4 obstacles; severity 1 "
          f"differs for {', '.join(checked)}; the obstacle scenarios "
          f"without obstacles equal clean at severity 1 "
          f"({time.perf_counter() - t0:.1f} s)")


def scen100_run(gnn100):
    """``scen100``: the schedule's severities every iteration, 3 graphs
    across both stage changes, iteration 1 equal to ``gnn100``'s, the
    learning gate over the clean stage, launches by replay and s/iteration
    per stage; returns the trainer and its launches."""
    import numpy as np

    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )

    graphs = []

    def track(trainer):
        run = trainer._iteration.run

        def counted(*args, **kwargs):
            graphs.append((trainer.graph_count(),
                           [id(p.graph) for p in trainer._phases]))
            run(*args, **kwargs)

        trainer._iteration.run = counted

    trainer, rewards, got, s_iter = train_run(
        "smoke_scen100", SCEN100, "scen100 M=1024 N=100 fused_chunk=10",
        before_train=track)
    del trainer._iteration.run
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if len(rewards) != 30 or got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"scen100: {len(rewards)} iterations, launches "
                             f"{got}, want 30 and fused {want}")
    schedule = schedule_from_cfg(SCEN100_SCHEDULE.split("=", 1)[1],
                                 default_severity=0.5)
    severities = [r["scenario_severity"] for r in trainer.smoke_records]
    expect = [float(np.float32(schedule.severity_at(i))) for i in range(30)]
    if severities != expect:
        raise AssertionError(f"scen100 severities {severities} != the "
                             f"schedule's {expect}")
    final = (trainer.graph_count(), [id(p.graph) for p in trainer._phases])
    at = {i: graphs[i][0] for i in (11, 12, 23, 24)}
    if not (set(at.values()) == {3} and final[0] == 3
            and graphs[2][1] == final[1]):
        raise AssertionError(f"scen100 graphs before/after iterations 12 "
                             f"and 24: {at}, at the end {final[0]}; the same "
                             f"graph objects: {graphs[2][1] == final[1]}")
    print(f"[graphs] scen100: captured graphs before and after the stage "
          f"changes (iterations 12, 13, 24, 25): {list(at.values())}; at the "
          f"end {final[0]}, the same graph objects as at iteration 3")
    if rewards[0] != gnn100["rewards"][0]:
        raise AssertionError(f"scen100 iteration 1 {rewards[0]!r} != "
                             f"gnn100's {gnn100['rewards'][0]!r}")
    first3, late = mean(rewards[:3]), mean(rewards[9:12])
    print(f"[learn] scen100 reward by iteration: " + ", ".join(
        f"{i + 1}: {r:.3f}" for i, r in enumerate(rewards))
        + f"; iteration 1 {rewards[0]!r} == gnn100's; first 3 {first3:.3f},"
        f" iterations 10-12 {late:.3f}")
    if not late >= first3 + LEARN_MARGIN:
        raise AssertionError(f"scen100: iterations 10-12 mean {late:.3f} do "
                             f"not beat the first 3 {first3:.3f} by "
                             f"{LEARN_MARGIN}")
    steady = trainer.smoke_phase_ms
    per_stage = []
    for a, b in SCEN100_STAGES:
        rows = [sum(p) / 1e3 for p in steady[max(a, 2):b]]
        per_stage.append(mean(rows))
    print(f"[scen100] s/iteration by stage (clean; wind/sensor/fault 0.5; "
          f"storm 0.5-1.0), warm-up and capture iterations left out: "
          + ", ".join(f"{x:.4f}" for x in per_stage)
          + f"; whole run {s_iter:.4f}; gnn100's {gnn100['s_iter']:.4f} "
          f"(ratio {s_iter / gnn100['s_iter']:.3f})")
    profile_window(lambda: trainer._dispatch(1), "train scen100 M=1024 "
                   "N=100 under storm, one captured iteration", 1,
                   "iteration")
    return trainer, got["knn_fused"]


def scenario_evals(scen100, gnn100):
    """The evaluate CLI on ``scen100``'s checkpoint under wind and storm at
    0.5 (M=4096, full episodes): learned > zero; ``gnn100``'s policy row
    beside it; eval formation-steps/s under storm against clean."""
    import torch

    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        episode_length,
        evaluate,
        evaluate_checkpoint,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        scenario_params_for,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    ckpt = latest_checkpoint(scen100.log_dir)
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    for name in SCENARIO_EVALS:
        res = evaluate_cli.main([
            f"checkpoint={ckpt}", "obs_mode=knn", "policy=gnn",
            "num_agents_per_formation=100", "eval_formations=4096",
            f"scenario={name}", "scenario_severity=0.5", "device=cuda",
        ])
        ret = {r: res[f"{r}_episode_return_per_agent"]
               for r in ("policy", "baseline", "zero")}
        if not ret["policy"] > ret["zero"]:
            raise AssertionError(f"scen100 under {name}: learned "
                                 f"{ret['policy']} does not beat zero "
                                 f"{ret['zero']}")
        plain = evaluate_checkpoint(
            str(gnn100["ckpt"]), params, 4096, 1234, True, "cuda",
            scenario_params=scenario_params_for(name, 0.5),
        )["episode_return_per_agent"]
        print(f"[scenario-eval] {name} 0.5 (M=4096 N=100, full episodes): "
              f"scen100 learned {ret['policy']:.2f}, baseline "
              f"{ret['baseline']:.2f}, zero {ret['zero']:.2f}; gnn100's "
              f"checkpoint (clean-trained) {plain:.2f} (not gated)")
    # Eval throughput under storm against clean: the learned policy, 302
    # steps each, alternating clean, storm, storm, clean.
    short = params.replace(max_steps=300)
    act = policy_act_fn(scen100.model, short)
    storm = scenario_params_for("storm", 0.5)
    rates = {"clean": [], "storm": []}
    for which in ("clean", "storm", "storm", "clean"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(act, short, 4096, seed=1234, device="cuda",
                 scenario_params=storm if which == "storm" else None)
        torch.cuda.synchronize()
        rates[which].append(4096 * episode_length(short)
                            / (time.perf_counter() - t0))
    clean_r, storm_r = mean(rates["clean"]), mean(rates["storm"])
    print(f"[scenario-eval] eval formation-steps/s at M=4096 N=100 "
          f"(302 steps, two runs each): clean {clean_r:.1f} "
          f"{[round(x, 1) for x in rates['clean']]}, storm {storm_r:.1f} "
          f"{[round(x, 1) for x in rates['storm']]}; scenario overhead "
          f"{100 * (clean_r / storm_r - 1):.1f}% (time under storm over "
          f"clean, less one)")


def scenario_captured_equals_eager():
    """Ring/MLP, M=64, bitwise: captured == eager over 4 iterations across
    a stage boundary and a severity ramp; ``fused_chunk=2`` == the host
    loop with the stage change inside the second chunk, records included;
    and a run resumed mid-stage == the uninterrupted one."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )

    params = EnvParams()
    base = ROOT / "logs" / "smoke_scenario_compare"
    shutil.rmtree(base, ignore_errors=True)
    ppo = PPOConfig(batch_size=800)  # 4 minibatches an epoch
    per_iter = 10 * 64 * 5

    def make(name, schedule, capture=True, **kw):
        cfg = dict(num_formations=64, seed=3, checkpoint=False,
                   total_timesteps=4 * per_iter, log_dir=str(base / name))
        cfg.update(kw)
        return Trainer(params, ppo, TrainConfig(**cfg),
                       model=MLPActorCritic(
                           params.obs_dim,
                           generator=torch.Generator().manual_seed(3)),
                       device="cuda", capture=capture,
                       scenario_schedule=schedule_from_cfg(schedule))

    def carry(trainer):
        out = _carry(trainer)
        it = trainer._iteration
        out.update({f: getattr(it.env, f).clone() for f in it.env_fields})
        out["scenario generator"] = trainer.scenario_generator.get_state()
        out["scenario wind"] = trainer.scenario_params.wind.clone()
        return out

    def compare(a, b, what, skip=()):
        torch.cuda.synchronize()
        x, y = carry(a), carry(b)
        for key in x:
            if key not in skip and not torch.equal(x[key], y[key]):
                raise AssertionError(f"{what}: {key} differs")

    def records(trainer):
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("time", "env_steps_per_sec")}
                for line in (Path(trainer.log_dir) / "metrics.jsonl")
                .read_text().splitlines()]

    ramp = ("[{rollouts: 2, scenarios: [clean]}, {rollouts: 2, scenarios: "
            "[wind, sensor_noise, actuator_fault, comm_dropout], severity: "
            "1.0, severity_start: 0.3}]")
    runs = [make(f"ramp{c}", ramp, capture=c) for c in (True, False)]
    for t in runs:
        t.train()
    compare(*runs, "scenario captured vs eager")
    if runs[0].graph_count() != 3:
        raise AssertionError(f"{runs[0].graph_count()} graphs, want 3")

    inside = ("[{rollouts: 3, scenarios: [storm, comm_dropout, "
              "moving_goal], severity: 1.0, severity_start: 0.2}, "
              "{rollouts: 2, scenarios: [actuator_fault, sensor_noise, "
              "wind], severity: 0.7}]")
    host, fused = make("host", inside), make("fused", inside, fused_chunk=2)
    host.train()
    fused.train()
    compare(host, fused, "scenario fused vs host loop", skip=("metrics",))
    if records(host) != records(fused):
        raise AssertionError("scenario fused vs host loop: records differ")

    kw = dict(checkpoint=True, save_freq=10)
    full = make("full", inside, **kw)
    full.train()
    make("part", inside, total_timesteps=2 * per_iter, **kw).train()
    resumed = make("part", inside, resume=True, **kw)
    resumed.train()
    compare(full, resumed, "scenario resumed mid-stage", skip=("metrics",))
    print("[capture] scenarios ring/MLP M=64, bitwise: captured == eager "
          "over 4 iterations across a stage boundary and a severity ramp "
          "(params, Adam state, step, env carry with the episode draws, "
          "metrics, both generators, the scenario buffers; 3 graphs); "
          "fused_chunk=2 == the host loop with the stage change inside the "
          "second chunk, records included; resumed at rollout 2 of the "
          "3-rollout stage == uninterrupted")


def scenario_phase(gnn100):
    """Phase 8; returns ``scen100``'s ``knn_fused`` launches and its last
    checkpoint (phase 9 judges it)."""
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    scenario_identity(gnn100["model"])
    elapsed("scenario identity")
    trainer, launches = scen100_run(gnn100)
    elapsed("scen100")
    scenario_evals(trainer, gnn100)
    elapsed("scenario evals")
    scenario_captured_equals_eager()
    return launches, latest_checkpoint(trainer.log_dir)


# Phase 9: the robustness matrix, the falsifier search and pursuit-evasion.
MATRIX_SCENARIOS = ("clean", "wind", "storm", "sensor_noise", "comm_dropout")
MATRIX_SEVERITIES = (0.0, 0.5, 1.0)
MATRIX1024_SCENARIOS = ("clean", "storm")
MATRIX1024_SEVERITIES = (0.0, 1.0)
MATRIX_RTOL = 1e-5  # a captured cell against the eager evaluate_scenario
ADVERSARY = ("scenarios=[wind,storm,actuator_fault,sensor_noise]",
             "search_grid=6", "search_generations=4", "eval_formations=64")
ADVERSARY_M = 64
# gnn100's command on pursuit-evasion, 20 iterations.
CHASE100 = GNN100[:-1] + ("env=pursuit_evasion", "total_timesteps=20480000",
                          "fused_chunk=10")


def yaml_list(items):
    return "[" + ",".join(str(x) for x in items) + "]"


def matrix_run(label, ckpts, n, m, scenarios, severities, kernel):
    """The robustness-matrix CLI in-process (``main(argv)``) on ``ckpts``
    (one architecture) with the launch counts set to 0 just before it:
    one build (``eval_compiles``), ``kernel`` launched episode_length + 1
    times a cell and the other never, every metric finite, and every
    severity-0 cell bitwise its checkpoint's clean cell. Returns the
    report, the launches and the wall seconds."""
    import torch

    from marl_distributedformation_tpu_torch import robustness_matrix
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    torch.cuda.synchronize()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    report = robustness_matrix.main([
        f"name=smoke_{label}", f"checkpoint={yaml_list(ckpts)}",
        "obs_mode=knn", f"num_agents_per_formation={n}",
        f"scenarios={yaml_list(scenarios)}",
        f"severities={yaml_list(severities)}", f"eval_formations={m}",
        "device=cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    cells = len(ckpts) * len(scenarios) * len(severities)
    T = 1002
    other = "knn_tiled" if kernel == "knn_fused" else "knn_fused"
    if launches != {kernel: cells * (T + 1), other: 0}:
        raise AssertionError(f"{label}: launches {launches}, want {kernel} "
                             f"{cells} x {T + 1}")
    if report["eval_compiles"] != 1:
        raise AssertionError(f"{label}: {report['eval_compiles']} builds")
    for ckpt, per_scenario in report["matrix"].items():
        clean = per_scenario["clean"]["0"]
        for scenario, per_sev in per_scenario.items():
            for sev, metrics in per_sev.items():
                if not all(math.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f"{label}: non-finite {scenario} "
                                         f"{sev}: {metrics}")
            if per_sev["0"] != clean:
                raise AssertionError(f"{label}: {scenario} at severity 0 "
                                     f"!= the clean cell of {ckpt}")
    print(f"[matrix] {label}: {len(ckpts)} checkpoints x {len(scenarios)} "
          f"scenarios x {len(severities)} severities at M={m} N={n}, full "
          f"episodes: {wall:.2f} s through the CLI ({wall / cells:.3f} s a "
          f"cell with loading, warm-up and capture), eval_compiles 1, "
          f"launches {launches} by replay; every severity-0 cell == its "
          f"checkpoint's clean cell bitwise")
    return report, launches, wall


def cell_rate(program, params, name, severity, reps):
    """Seconds a cell and formation-steps/s over ``reps`` cells of
    ``program`` (built already), the host's clock around synchronised
    cells."""
    import torch

    from marl_distributedformation_tpu_torch.scenarios import (
        scenario_params_for,
    )

    sp = scenario_params_for(name, severity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        program.run(params, sp)
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / reps
    return s, program.num_formations * 1002 / s


def matrix100(gnn100, scen100_ckpt):
    """``matrix100``: the CLI on ``gnn100``'s and ``scen100``'s checkpoints
    (5 scenarios x 3 severities, M=256); then the wind 0.5 cell against the
    eager ``eval.evaluate_scenario``, and s/cell captured beside eager."""
    import torch

    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        evaluate_scenario,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.scenarios import MatrixProgram

    ckpts = [str(gnn100["ckpt"]), str(scen100_ckpt)]
    report, launches, _ = matrix_run("matrix100", ckpts, 100, 256,
                                     MATRIX_SCENARIOS, MATRIX_SEVERITIES,
                                     "knn_fused")
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    pol = LoadedPolicy.from_checkpoint(ckpts[0], env_params=params,
                                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = evaluate_scenario(policy_act_fn(pol.model, params), params,
                              "wind", 0.5, 256, 1234, "cuda")
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    cell = report["matrix"][ckpts[0]]["wind"]["0.5"]
    err = max(abs(cell[k] - eager[k]) / max(abs(eager[k]), 1e-30)
              for k in eager)
    if err > MATRIX_RTOL:
        raise AssertionError(f"matrix100 wind 0.5 cell {cell} != eager "
                             f"evaluate_scenario {eager} (rel {err})")
    print(f"[matrix] matrix100 wind 0.5, gnn100's checkpoint: captured cell "
          f"== eager evaluate_scenario within rtol {MATRIX_RTOL} (max rel "
          f"err {err:.3g}; bitwise: {cell == eager})")
    storm = {Path(c).parent.name: report["matrix"][c]["storm"]["1"]
             ["episode_return_per_agent"] for c in ckpts}
    print(f"[matrix] storm 1.0 return/agent (M=256 N=100, full episodes): "
          + ", ".join(f"{k} {v:.2f}" for k, v in storm.items()))
    prog = MatrixProgram(pol.model, params, 256, device="cuda")
    prog.evaluate_clean(pol.params)  # the build and the capture
    cs, cr = cell_rate(prog, pol.params, "wind", 0.5, 2)
    er = 256 * 1002 / eager_s
    print(f"[matrix] matrix100 cell (wind 0.5, M=256 N=100, 1002 steps): "
          f"captured {cs:.4f} s a cell, {cr:.1f} formation-steps/s; the "
          f"eager eval.evaluate_scenario {eager_s:.4f} s, {er:.1f} "
          f"formation-steps/s ({eager_s / cs:.2f}x)")
    return launches


def matrix1024(ckpt):
    """``matrix1024``: the CLI on ``gnn1024``'s checkpoint (clean and storm
    at 0 and 1.0, M=32) through ``knn_tiled``."""
    _, launches, _ = matrix_run("matrix1024", [str(ckpt)], 1024, 32,
                                MATRIX1024_SCENARIOS, MATRIX1024_SEVERITIES,
                                "knn_tiled")
    return launches


def adversary100(gnn100, scen100_ckpt):
    """``adversary100``: the falsifier-search CLI on ``gnn100``'s and
    ``scen100``'s checkpoints (4 families, grid 6, 4 generations, M=64:
    P=25, 1600 formations), one build across both; each falsifier and the
    highest safe probe below it re-evaluated through the search's
    ``evaluate_cells``: drop above the tolerance, and at most it. Then one
    generation at the default population (all 10 families, P=61, 3904
    formations), every severity-0 row bitwise the clean row. Returns the
    search's and the P=61 run's launches."""
    import torch

    from marl_distributedformation_tpu_torch import adversarial_search
    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.scenarios import (
        AdversaryConfig,
        AdversarySearch,
        get_scenario,
        make_population_runner,
    )
    from marl_distributedformation_tpu_torch.scenarios.adversary import (
        _relative_drop,
        _stack_rows,
    )

    ckpts = [str(gnn100["ckpt"]), str(scen100_ckpt)]
    torch.cuda.synchronize()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    # The CLI's work (``main`` is ``run(argv)[0]``), keeping its search for
    # the brackets and the re-evaluation.
    report, search = adversarial_search.run([
        "name=smoke_adversary100", f"checkpoint={yaml_list(ckpts)}",
        "obs_mode=knn", "num_agents_per_formation=100", *ADVERSARY,
        "device=cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    generations = sum(r["generations"] for r in report["searches"].values())
    if launches != {"knn_fused": generations * 1003, "knn_tiled": 0}:
        raise AssertionError(f"adversary100 launches {launches}, want "
                             f"{generations} x 1003")
    if report["eval_compiles"] != 1:
        raise AssertionError(f"adversary100: {report['eval_compiles']} "
                             "builds across both checkpoints")
    tol = report["drop_tolerance"]
    for ckpt, rep in report["searches"].items():
        params = LoadedPolicy.from_checkpoint(
            ckpt, env_params=search.env_params, device="cuda").params
        clean = rep["clean"]
        # Each falsifier beside the highest safe probe below it (the
        # bracket's floor; 0 when no probe below it was safe).
        brackets = []
        for f in rep["falsifiers"]:
            lo, hi = search.brackets[ckpt][f["scenario"]]
            if round(hi, 6) != f["severity"]:  # the record's rounding
                raise AssertionError(f"adversary100 {f['scenario']}: "
                                     f"bracket {lo, hi}, falsifier {f}")
            brackets.append((f, hi, lo))
        # One run of the search's program re-evaluates them all.
        again = search.evaluate_cells(params, [("clean", 0.0)] + [
            cell for f, hi, lo in brackets
            for cell in ((f["scenario"], hi), (f["scenario"], lo))])
        for i, (f, _, safe) in enumerate(brackets):
            drops = [_relative_drop(v, again[0])
                     for v in again[1 + 2 * i:3 + 2 * i]]
            if not (f["drop"] > tol and drops[0] > tol and drops[1] <= tol):
                raise AssertionError(
                    f"adversary100 {Path(ckpt).parent.name} {f['scenario']}:"
                    f" falsifier {f['severity']} drop {f['drop']} (again "
                    f"{drops[0]}), safe probe {safe} drop {drops[1]}, "
                    f"tolerance {tol}")
            print(f"[adversary] {Path(ckpt).parent.name} {f['scenario']}: "
                  f"falsified at {f['severity']} (drop {drops[0]:.4f} > "
                  f"{tol}), safe at {safe:.6g} (drop {drops[1]:.4f}), "
                  "re-evaluated through evaluate_cells")
        print(f"[adversary] {Path(ckpt).parent.name}: clean {clean:.2f}, "
              f"falsifiers {[(f['scenario'], f['severity']) for f in rep['falsifiers']]}"
              f", robust {rep['robust']}, {rep['generations']} generations "
              f"in {rep['search_seconds']:.2f} s")
    if search.compile_count != 1:
        raise AssertionError("adversary100: the re-evaluation rebuilt")
    print(f"[adversary] adversary100: P={report['searches'][ckpts[0]]['population']}"
          f" x M={ADVERSARY_M} = (1600,100,4) a generation, {generations} "
          f"generations over 2 checkpoints, eval_compiles 1, "
          f"{report['candidates_per_sec']:.1f} candidates/s (search time), "
          f"{wall:.2f} s through the CLI; launches {launches} by replay")

    # One generation at the default population: P = 1 + 10 x 6 = 61.
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    pol = LoadedPolicy.from_checkpoint(ckpts[0], env_params=params,
                                       device="cuda")
    families = AdversarySearch(pol.model, params, AdversaryConfig(),
                               device="cuda").specs
    rows = [(get_scenario("clean"), 0.0)] + [
        (spec, 0.0) for spec in families for _ in range(6)]
    run, guard = make_population_runner(pol.model, params, ADVERSARY_M,
                                        device="cuda")
    torch.cuda.synchronize()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    out = run(pol.params, _stack_rows(rows))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    p61 = dict(knn_cuda.LAUNCHES)
    if p61 != {"knn_fused": 1003, "knn_tiled": 0} or guard.count != 1:
        raise AssertionError(f"P=61 launches {p61}, builds {guard.count}")
    for key, values in out.items():
        bad = [i for i in range(1, len(rows))
               if not torch.equal(values[i], values[0])]
        if bad:
            raise AssertionError(
                f"P=61: the {key} of severity-0 rows {bad} (of "
                f"{[rows[i][0].name for i in bad]}) differs from the clean "
                f"row's {values[0].item()!r}: {values[bad].tolist()}")
    print(f"[adversary] P=61 x M={ADVERSARY_M} = ({61 * ADVERSARY_M},100,4), "
          f"all 10 families at severity 0: every row == the clean row "
          f"bitwise (6 metrics); knn_fused 1003 launches by replay; one "
          f"generation with its build and capture {s:.3f} s, "
          f"{61 / s:.1f} candidates/s, "
          f"{61 * ADVERSARY_M * 1002 / s:.1f} formation-steps/s")
    return launches, p61


def pursuit_identity(model):
    """Pursuit at N=100, M=1024, 50 steps through a reset (max_steps 40),
    ``knn_fused``: every scenario at severity 0 equals clean pursuit
    bitwise; ``moving_goal`` at 0.5 (the pursuer drifts) differs."""
    from marl_distributedformation_tpu_torch.envs import PursuitParams
    from marl_distributedformation_tpu_torch.scenarios import (
        registered_scenarios,
        scenario_params_for,
    )

    params = PursuitParams(num_agents=100, obs_mode="knn", knn_k=4,
                           max_steps=40)
    clean = scenario_roll(model, params, None)
    names = [n for n in registered_scenarios() if not n.startswith("adv:")]
    for name in names:
        if not rolls_equal(clean, scenario_roll(
                model, params, scenario_params_for(name, 0.0))):
            raise AssertionError(f"pursuit: {name} at severity 0 differs "
                                 "from clean")
    if rolls_equal(clean, scenario_roll(
            model, params, scenario_params_for("moving_goal", 0.5))):
        raise AssertionError("pursuit: moving_goal at 0.5 equals clean")
    print(f"[chase] pursuit severity 0 == clean bitwise for {len(names)} "
          f"scenarios (N=100 M=1024, {IDENTITY_STEPS} steps through a "
          "reset, knn_fused); moving_goal at 0.5 differs")


def chase100(gnn100):
    """``chase100``: ``gnn100``'s command on pursuit-evasion, 20 captured
    iterations through ``knn_fused``, against a control run of the same
    command with ``learning_rate=0`` (the seeded policy, never updated):
    finite records; the same first iteration; the last 3 iterations' mean
    reward above the control's over the same episode steps; at M=1024 over
    full episodes, the learned policy with its noise above the seeded
    policy with its noise and above zero (its mean action printed, not
    gated); the severity-0 identity on pursuit. Returns its launches."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.envs import PursuitParams
    from marl_distributedformation_tpu_torch.eval import evaluate_checkpoint
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    seeded = {}

    def keep_seeded(trainer):
        # The seeded policy, before its first update.
        seeded["ckpt"] = trainer.save()

    trainer, rewards, got, s_iter = train_run(
        "smoke_chase100", CHASE100,
        "chase100 pursuit-evasion M=1024 N=100 fused_chunk=10",
        before_train=keep_seeded)
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if len(rewards) != 20 or got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"chase100: {len(rewards)} iterations, "
                             f"launches {got}, want 20 and fused {want}")
    print(f"[chase] chase100 {s_iter:.4f} s/iteration against gnn100's "
          f"{gnn100['s_iter']:.4f} (ratio {s_iter / gnn100['s_iter']:.3f})")
    # Every formation starts its episode at once and the 20 iterations
    # cover its steps 0-199, so an iteration's reward follows the pursuer
    # closing in as much as the policy: the control run sees the same
    # steps from the same states and streams, without the updates.
    _, control, _, _ = train_run(
        "smoke_chase100_control", CHASE100 + ("learning_rate=0.0",),
        "chase100 control, learning_rate=0")
    for label, r in (("chase100", rewards), ("control", control)):
        print(f"[learn] {label} reward by iteration: " + ", ".join(
            f"{i + 1}: {v:.3f}" for i, v in enumerate(r))
            + f"; first 3 {mean(r[:3]):.3f}, last 3 {mean(r[-3:]):.3f}")
    if not math.isclose(rewards[0], control[0], rel_tol=1e-5):
        raise AssertionError(f"chase100: iteration 1 {rewards[0]} and the "
                             f"control's {control[0]} differ")
    last3, control3 = mean(rewards[-3:]), mean(control[-3:])
    if not last3 > control3:
        raise AssertionError(f"chase100: last-3 mean {last3:.3f} does not "
                             f"beat the control's {control3:.3f}")
    print(f"[learn] chase100: last 3 iterations {last3:.3f} > the "
          f"learning_rate=0 control's {control3:.3f} over the same steps")
    # The policy as it trained, with its noise, over full episodes; the
    # seeded policy under the same noise streams.
    ckpt = latest_checkpoint(trainer.log_dir)
    res = evaluate_cli.main([
        f"checkpoint={ckpt}", "env=pursuit_evasion", "obs_mode=knn",
        "policy=gnn", "num_agents_per_formation=100",
        "eval_formations=1024", "eval_deterministic=false", "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    params = PursuitParams(num_agents=100, obs_mode="knn", knn_k=4)
    # The CLI's call (its eval_seed 1234) with the seeded policy.
    ret["seeded"] = evaluate_checkpoint(
        seeded["ckpt"], params, 1024, 1234, False,
        "cuda")["episode_return_per_agent"]
    if not ret["policy"] > max(ret["seeded"], ret["zero"]):
        raise AssertionError(f"chase100: learned {ret['policy']} does not "
                             f"beat the seeded policy {ret['seeded']} and "
                             f"zero {ret['zero']}")
    mean_action = evaluate_checkpoint(
        str(ckpt), params, 1024, 1234, True,
        "cuda")["episode_return_per_agent"]
    print(f"[chase] chase100 eval (M=1024 N=100, full episodes, with the "
          f"policy's noise): learned {ret['policy']:.2f} > seeded "
          f"{ret['seeded']:.2f}, > zero {ret['zero']:.2f}; baseline (steers "
          f"at the pursuer) {ret['baseline']:.2f}; the learned mean action "
          f"{mean_action:.2f} (not gated)")
    pursuit_identity(trainer.model)
    return got["knn_fused"]


def robustness_phase(gnn100, scen100_ckpt):
    """Phase 9; returns each path's launches."""
    launches = {"matrix100": matrix100(gnn100, scen100_ckpt)}
    elapsed("matrix100")
    launches["matrix1024"] = matrix1024(gnn100["ckpt1024"])
    elapsed("matrix1024")
    launches["adversary100"], launches["population61"] = adversary100(
        gnn100, scen100_ckpt)
    elapsed("adversary100")
    launches["chase100"] = chase100(gnn100)
    return launches


# Phase 10: serving. The ladder, the smoke's sizes and clients, and the p95
# target of the JAX package's serving bench (bench.py:1538).
SERVE_BUCKETS = (1, 8, 64, 512)
SERVE_P95_MS = 50.0
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6  # served against LoadedPolicy.predict


def bf16_action_atol(num_layers: int) -> float:
    """``tests/bf16_budget.py``'s action budget of a depth-``num_layers``
    tanh-MLP served in bf16: two casts a layer and the obs cast, each half
    an ulp of bf16."""
    return (2 * num_layers + 1) * 2.0 ** -9


def serve_rows(m=1024):
    """Real k-NN request rows for the 100-agent GNN: the port's env at
    N=100, k=4, reset and stepped once with random actions, the
    observations built by ``compute_obs_knn`` through ``knn_fused``.
    Returns ``(rows (2m, 100, 20) numpy, knn_fused launches)``."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.env import EnvParams, make_vec_env
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    gen = torch.Generator(device="cuda").manual_seed(11)
    knn_cuda.reset_launches()
    reset_fn, step_fn = make_vec_env(params, m, device="cuda", generator=gen)
    state, obs = reset_fn()
    act = torch.rand((m, 100, 2), generator=gen, device="cuda") * 2 - 1
    _, tr = step_fn(state, act)
    rows = torch.cat([obs, tr.obs]).cpu().numpy()
    launches = knn_cuda.LAUNCHES["knn_fused"]
    if launches != 2 or not np.isfinite(rows).all():
        raise AssertionError(f"serve rows: {launches} knn_fused launches, "
                             "want 2, and finite observations")
    return rows, launches


def ring_rows(m=1024):
    """Flat request rows for the committed MLP: ring observations of the
    port's env at N=5, one row an agent."""
    import torch

    from marl_distributedformation_tpu_torch.env import EnvParams, make_vec_env

    gen = torch.Generator(device="cuda").manual_seed(12)
    reset_fn, _ = make_vec_env(EnvParams(), m, device="cuda", generator=gen)
    _, obs = reset_fn()
    return obs.reshape(-1, obs.shape[-1]).cpu().numpy()


def act_ms(engine, rows, reps):
    """CUDA events on the engine's stream around ``engine.act``: staging,
    the copy in, the rung, the copy out and the host's wait."""
    import torch

    with torch.cuda.stream(engine._stream):
        engine.act(rows)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            engine.act(rows)
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def replay_ms(graph, stream, reps):
    """CUDA events around back-to-back replays of one captured rung."""
    import torch

    with torch.cuda.stream(stream):
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def serve_ladder(label, policy, rows, layers):
    """The captured ladder against the eager one, rung by rung: bitwise,
    served == ``LoadedPolicy.predict`` within tolerance, two stochastic
    dispatches differ, bf16 against f32; then each rung's replay, act and
    eager act times. Returns the captured engine."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )

    engine = BucketedPolicyEngine(policy, buckets=SERVE_BUCKETS)
    eager = BucketedPolicyEngine(policy, buckets=SERVE_BUCKETS, capture=False)
    bf16 = BucketedPolicyEngine(policy, buckets=SERVE_BUCKETS,
                                dtype="bfloat16")
    worst = bf16_worst = 0.0
    for b in SERVE_BUCKETS:
        x = rows[:b]
        got, want = engine.act(x), eager.act(x)
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: captured rung {b} differs from "
                                 f"eager by {np.abs(got - want).max()}")
        ref, _ = policy.predict(x)
        np.testing.assert_allclose(got, ref, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL,
                                   err_msg=f"{label} rung {b} vs predict")
        worst = max(worst, float(np.abs(got - ref).max()))
        bf16_worst = max(bf16_worst, float(np.abs(bf16.act(x) - got).max()))
    big = rows[: 2 * SERVE_BUCKETS[-1] + 70]  # two top chunks and a 64-rung
    np.testing.assert_allclose(engine.act(big), policy.predict(big)[0],
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)
    a1 = engine.act(rows[:64], deterministic=False)
    a2 = engine.act(rows[:64], deterministic=False)
    if np.array_equal(a1, a2):
        raise AssertionError(f"{label}: two stochastic dispatches are equal")
    counts = engine.compile_counts()
    if counts != dict.fromkeys(SERVE_BUCKETS, 1):
        raise AssertionError(f"{label}: captures {counts}, want 1 a rung")
    print(f"[serve] {label}: captured == eager bitwise at rungs "
          f"{SERVE_BUCKETS}; served == predict within rtol {SERVE_RTOL} atol "
          f"{SERVE_ATOL} (max abs diff {worst:.3g}) and on {len(big)} rows "
          f"(3 chunks); stochastic dispatches differ; captures {counts}")
    if layers is not None:
        atol = bf16_action_atol(layers)
        if not bf16_worst <= atol:
            raise AssertionError(f"{label}: bf16 ladder off f32 by "
                                 f"{bf16_worst}, budget {atol}")
        print(f"[serve] {label} bf16 ladder vs f32: max abs {bf16_worst:.3g} "
              f"within the budget {atol:.4g} ({layers} layers)")
    else:
        print(f"[serve] {label} bf16 ladder vs f32: max abs {bf16_worst:.3g} "
              "(a measurement, not gated: the budget is derived for a "
              "seeded-init tanh-MLP)")
    for b in SERVE_BUCKETS:
        reps = 200 if b < 512 else 50
        rung = engine.rung(b)
        t_replay = replay_ms(rung.graph.graph, engine._stream, reps)
        t_act = act_ms(engine, rows[:b], reps)
        t_eager = act_ms(eager, rows[:b], max(10, reps // 4))
        mb = rows[:b].nbytes / 1e6
        print(f"[serve] {label} rung {b}: replay {t_replay:.4f} ms (device, "
              f"events over back-to-back replays, {rung.graph.nodes} graph "
              f"nodes), act {t_act:.4f} ms (staging, {mb:.3f} MB in, replay, "
              f"out; events on the engine's stream), eager act "
              f"{t_eager:.4f} ms ({t_eager / t_act:.2f}x)")
    top = engine.rung(SERVE_BUCKETS[-1])
    stage = engine._stage_in[: SERVE_BUCKETS[-1]]
    with torch.cuda.stream(engine._stream):
        h2d = time_ms(lambda: top.x.copy_(stage, non_blocking=True), 50)
    print(f"[serve] {label} rung {SERVE_BUCKETS[-1]}: the copy in of "
          f"{stage.numel() * 4 / 1e6:.3f} MB from pinned memory "
          f"{h2d:.4f} ms ({stage.numel() * 4 / h2d / 1e6:.1f} GB/s)")
    return engine


def serve_stream(engine, registry, rows, serve_dir, scen100_ckpt, p100):
    """A mixed stream over every rung from 4 client threads with a hot swap
    from ``gnn100`` to ``scen100`` in its middle: no request dropped, one
    capture a rung, ``model_step`` never decreasing in completion order,
    the rung graphs the same objects, and actions after the swap equal to
    ``scen100``'s policy's."""
    import shutil
    import threading

    import numpy as np

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.serving import (
        MicroBatchScheduler,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
    )

    graphs = {b: id(engine.rung(b).graph.graph) for b in SERVE_BUCKETS}
    done, lock = [], threading.Lock()
    sizes = (1, 3, 8, 9, 40, 64, 100, 512, 600)
    futures = []
    step0 = registry.active_step

    def client(i):
        for j in range(12):
            n = sizes[(i + j) % len(sizes)]
            start = (i * 97 + j * 31) % (len(rows) - n)
            fut = sched.submit(rows[start:start + n], timeout_s=60.0)
            fut.add_done_callback(record)
            with lock:
                futures.append(fut)
            fut.result(timeout=120)

    def record(fut):
        # Completion order: the worker resolves futures one by one.
        with lock:
            done.append(None if fut.exception() is not None
                        else fut.result().model_step)

    with MicroBatchScheduler(engine, registry=registry, window_ms=2.0,
                             max_queue=1024) as sched:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 120.0
        while len(done) < 20 and time.perf_counter() < deadline:
            time.sleep(0.005)
        swap_step = checkpoint_step(scen100_ckpt) + step0 + 1
        shutil.copy(scen100_ckpt,
                    serve_dir / f"rl_model_{swap_step}_steps.msgpack")
        if not registry.refresh():
            raise AssertionError(f"serve: no swap to scen100: "
                                 f"{list(registry.load_errors)}")
        for t in threads:
            t.join(timeout=300)
        after = sched.submit(rows[:600]).result(timeout=120)
    if any(t.is_alive() for t in threads) or None in done:
        raise AssertionError("serve: a client stalled or a request failed")
    if len(done) != len(futures) or len(done) != 48:
        raise AssertionError(f"serve: {len(done)} of {len(futures)} "
                             "requests answered, want 48")
    if done != sorted(done) or done[0] != step0 or done[-1] != swap_step:
        raise AssertionError(f"serve: model_step out of order: {done}")
    counts = engine.compile_counts()
    if counts != dict.fromkeys(SERVE_BUCKETS, 1) or graphs != {
            b: id(engine.rung(b).graph.graph) for b in SERVE_BUCKETS}:
        raise AssertionError(f"serve: captures {counts} after the swap")
    scen = LoadedPolicy.from_checkpoint(scen100_ckpt, env_params=p100,
                                        device="cuda")
    np.testing.assert_allclose(after.actions, scen.predict(rows[:600])[0],
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)
    if after.model_step != swap_step:
        raise AssertionError(f"serve: step {after.model_step} after swap")
    print(f"[serve] gnn100 mixed stream (4 clients, sizes {sizes}, 48 "
          f"requests) with a hot swap to scen100 at step {swap_step}: all "
          f"answered, model_step monotonic ({done.count(step0)} at "
          f"{step0}, {done.count(swap_step)} at {swap_step}), captures "
          f"{counts} (the same graphs), actions after the swap == scen100's "
          f"predict within rtol {SERVE_RTOL}")


def serving_phase(gnn100_ckpt, scen100_ckpt, duration_s=3.0):
    """Phase 10: the ``gnn100`` checkpoint served at (100, 20) rows on real
    k-NN observations (``serve_ladder``, ``serve_stream``), the committed
    MLP checkpoint beside it, then ``run_smoke_benchmark`` on the
    ``gnn100`` scheduler (default sizes, 4 clients), its device busy share,
    and ``max_rate_at_slo`` at a 50 ms p95. Returns ``knn_fused``'s launches
    building the request rows."""
    import shutil

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.serving import (
        MicroBatchScheduler,
        ModelRegistry,
        max_rate_at_slo,
        run_smoke_benchmark,
    )

    import torch

    from marl_distributedformation_tpu_torch.models import MLPActorCritic

    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    rows, launches = serve_rows()
    mlp = LoadedPolicy.from_checkpoint(CKPT, device="cuda")
    flat = ring_rows()
    serve_ladder("mlp (committed checkpoint)", mlp, flat, layers=None)
    # The bf16 budget is derived for a seeded-init tanh-MLP (its fact 4);
    # the trained checkpoint's weights amplify more (the JAX engine's own
    # bf16 ladder is off its f32 one by more than the budget there too:
    # tests/test_torch_serving.py).
    seeded = LoadedPolicy(MLPActorCritic(
        flat.shape[1], generator=torch.Generator().manual_seed(0)).to("cuda"))
    serve_ladder("mlp (seeded init, 64x64)", seeded, flat,
                 layers=seeded.model.depth + 1)
    elapsed("serve mlp")

    serve_dir = ROOT / "logs" / "smoke_serve100"
    shutil.rmtree(serve_dir, ignore_errors=True)
    serve_dir.mkdir(parents=True)
    shutil.copy(gnn100_ckpt, serve_dir / Path(gnn100_ckpt).name)
    registry = ModelRegistry(serve_dir, env_params=p100, device="cuda")
    engine = serve_ladder("gnn100", registry.policy, rows, layers=None)
    elapsed("serve gnn100 ladder")
    serve_stream(engine, registry, rows, serve_dir, scen100_ckpt, p100)
    elapsed("serve gnn100 stream and swap")

    with MicroBatchScheduler(engine, registry=registry) as sched:
        r = run_smoke_benchmark(sched, row_shape=rows.shape[1:],
                                duration_s=duration_s, num_clients=4,
                                registry=registry)
        if r["client_requests_ok"] == 0 or r["timeouts_total"]:
            raise AssertionError(f"serve smoke: {r}")
        print(f"[serve] smoke gnn100 (sizes 1,3,8,9,40,100 formations of "
              f"100 agents, 4 clients, {r['duration_s']} s): "
              f"{r['requests_per_sec']:.1f} requests/s, "
              f"{r['rows_per_sec']:.1f} rows/s, "
              f"{r['rows_per_sec'] * 100:.1f} agent-rows/s; p50 "
              f"{r['latency_p50_ms']:.3f} ms, p95 {r['latency_p95_ms']:.3f}"
              f" ms, p99 {r['latency_p99_ms']:.3f} ms; occupancy "
              f"{r['batch_occupancy_pct']:.1f}%, "
              f"{r['mean_rows_per_batch']:.1f} rows a batch, "
              f"{r['batches']:.0f} batches; rejected "
              f"{r['client_rejected']:.0f}")
        seen = {}

        def smoke():
            seen.update(run_smoke_benchmark(
                sched, row_shape=rows.shape[1:], duration_s=1.5,
                num_clients=4, seed=1))

        profile_window(smoke, "serve gnn100 smoke, 1.5 s profiled "
                       "(the profiler slows the host)", 1, "window")
        print(f"[serve] the profiled smoke: "
              f"{seen['requests_per_sec']:.1f} requests/s, p95 "
              f"{seen['latency_p95_ms']:.3f} ms")
        elapsed("serve smoke")
        best, reports = max_rate_at_slo(
            sched, rows.shape[1:], SERVE_P95_MS, probe_duration_s=1.0,
            iterations=4, seed=3)
        last = reports[-1]
        print(f"[serve] max_rate_at_slo gnn100 (p95 <= {SERVE_P95_MS} ms, "
              f"loss <= 1%, loadgen's default size mix 1/4/16/64/256 "
              f"formations): {best:.1f} requests/s over {len(reports)} "
              f"probes; last probe {last.offered_rps:.1f} offered, p95 "
              f"{last.p95_ms:.3f} ms, loss {last.loss_fraction:.3f}")
    if engine.compile_counts() != dict.fromkeys(SERVE_BUCKETS, 1):
        raise AssertionError(f"serve: captures {engine.compile_counts()}")
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
                      {"train": (1024, 100, 4), "eval": (4096, 100, 4),
                       "population": (4096, 100, 4),
                       "matrix": (256, 100, 4),
                       "adversary": (25 * ADVERSARY_M, 100, 4),
                       "population61": (61 * ADVERSARY_M, 100, 4)}),
        "knn_tiled": (knn_cuda.knn_tiled, 50,
                      {"train": (8, 1024, 4), "eval": (512, 1024, 4),
                       "population": (16, 1024, 4),
                       "matrix": (32, 1024, 4)}),
    }
    stats = {}
    for name, (fn, reps, by_path) in shapes.items():
        done = {}  # a shape two paths share is checked once
        for path, shape in by_path.items():
            if shape not in done:
                done[shape] = check_kernel(name, fn, *shape, reps)
            stats.setdefault(name, {})[path] = done[shape]

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

    # Phase 5: training through the kernels.
    launches, gnn100 = train_phase()
    elapsed("phase 5, training")

    # Phase 6: populations through the kernels.
    pop_launches = population_phase(gnn100)
    elapsed("phase 6, populations")

    # Phase 7: CTDE and the curriculum, this slice's main paths.
    ctde_knn_launches = ctde_phase()
    curriculum_phase()
    elapsed("phase 7, CTDE and the curriculum")

    # Phase 8: scenarios.
    scen_launches, scen100_ckpt = scenario_phase(gnn100)
    elapsed("phase 8, scenarios")

    # Phase 9: the robustness matrix, the falsifier search and
    # pursuit-evasion, this slice's main paths.
    robust = robustness_phase(gnn100, scen100_ckpt)
    elapsed("phase 9, robustness matrix, falsifier search, pursuit")

    # Phase 10: serving, this slice's main path.
    serve_launches = serving_phase(gnn100["ckpt"], scen100_ckpt)
    elapsed("phase 10, serving")

    replaces = {
        "knn_fused": "marl_distributedformation_tpu/ops/knn_pallas.py:117",
        "knn_tiled": "marl_distributedformation_tpu/ops/knn_pallas.py:155",
    }
    paths = {"knn_fused": "train gnn100", "knn_tiled": "train gnn1024"}
    pop_paths = {"knn_fused": "train pop4", "knn_tiled": "train pop1024"}
    # The launches and timings of the training path that launches each
    # kernel (this slice's main path); those of phase 3's eval under "eval".
    kernels = [
        {"name": name, "route": "cuda",
         "source": "marl_distributedformation_tpu_torch/csrc/knn.cu",
         "replaces": replaces[name], "path": paths[name],
         "launches": launches[name], **stats[name]["train"],
         "library_ms": None,
         "eval": {"launches": eval_launches[name], **stats[name]["eval"]},
         "population": {"path": pop_paths[name],
                        "launches": pop_launches[name],
                        **stats[name]["population"]}}
        for name in ("knn_fused", "knn_tiled")
    ]
    # The CTDE actor on k-NN observations launches knn_fused at the train
    # shape, (1024,100,4), timed above.
    kernels[0]["ctde_knn"] = {"path": "train ctde_knn",
                              "launches": ctde_knn_launches,
                              "shape": stats["knn_fused"]["train"]["shape"]}
    # scen100 launches knn_fused at gnn100's shape, (1024,100,4).
    kernels[0]["scenario"] = {"path": "train scen100",
                              "launches": scen_launches,
                              "shape": stats["knn_fused"]["train"]["shape"]}
    # Phase 9's paths, each at its own shape (timed in phase 2).
    for i, name in enumerate(("knn_fused", "knn_tiled")):
        kernels[i]["matrix"] = {
            "path": "matrix100" if i == 0 else "matrix1024",
            "launches": robust["matrix100" if i == 0
                               else "matrix1024"][name],
            **stats[name]["matrix"]}
    kernels[0]["adversary"] = {"path": "adversary100",
                               "launches": robust["adversary100"]["knn_fused"],
                               **stats["knn_fused"]["adversary"]}
    kernels[0]["population61"] = {
        "path": "adversary100 P=61",
        "launches": robust["population61"]["knn_fused"],
        **stats["knn_fused"]["population61"]}
    # Phase 10's request rows: env states through knn_fused at the train
    # shape, (1024,100,4), timed above (the served GNN reads its neighbor
    # indices from the rows and launches no kernel).
    kernels[0]["serving"] = {"path": "serve100 request rows",
                             "launches": serve_launches,
                             "shape": stats["knn_fused"]["train"]["shape"]}
    kernels[0]["chase"] = {"path": "train chase100",
                           "launches": robust["chase100"],
                           "shape": stats["knn_fused"]["train"]["shape"]}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
