#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``marl_distributedformation_tpu_torch/csrc`` with ``nvcc``.
2. Hold each k-NN kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it — fused (M=4096, N=100, k=4), tiled
   (M=512, N=1024, k=4) — and on lattice, duplicate and edge-clipped points
   (exact ties) and masks with fewer than k valid points: ``idx`` and
   offsets bitwise, distances within 1 ulp. Then time kernel and plain
   version with CUDA events, with the SM clock, power and temperature
   sampled before and after each kernel's window.
3. Drive the port's k-NN swarm evaluation at full width with a GNN from a
   seeded init: N=100, M=4096 for a full episode (1002 steps; the fused
   kernel must launch 1003 times), and N=1024, M=512 for 101 steps (the
   tiled kernel must launch 102 times). Check finite outputs, and that the
   kernel path equals the plain path end to end on a small batch.
4. Evaluate the committed MLP checkpoint (N=5, M=4096, full episode) through
   the port's evaluate CLI: learned > baseline > zero.
5. Print the kernels' JSON line, the card line, and the last line
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
    ms = time_ms(lambda: kernel(pts, k), reps)
    print(f"[smi] after {name} timing: {smi_sample()}")
    plain_ms = time_ms(lambda: knn_batch_torch(pts, k), max(2, reps // 20), 1)
    bound_ms, bound_by = knn_bound_ms(m, n, k, with_valid=False)
    print(f"[kernel] {name} ({m},{n},{k}): ok, max_abs_err {err}, "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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


def profile_breakdown(model, params, m, steps=4, top=8):
    """Device time by kernel over a short evaluation (``steps`` + 2 steps)
    under ``torch.profiler``, and the device's busy share of the window's
    wall time (profiling slows the host, so the share may read low). Prints
    the ``top`` kernels and every k-NN kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marl_distributedformation_tpu_torch.eval import evaluate, policy_act_fn

    p = params.replace(max_steps=steps)
    act = policy_act_fn(model, p)
    evaluate(act, p, m, seed=5, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate(act, p, m, seed=5, device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Only the kernels themselves: an operator's row also carries the
    # device time of the kernels it launched, which would count them twice.
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
    ]
    total = sum(dev_us(e) for e in events)
    T = steps + 2
    if total == 0:
        print(f"[profile] N={params.num_agents} M={m}: no device time in "
              "the trace (not measured)")
        return
    print(f"[profile] N={params.num_agents} M={m}, {T} steps: device busy "
          f"{total / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"({100 * total / wall_us:.1f}%), {total / T / 1e3:.4f} ms/step")
    # The k-NN kernels always, on the episode's own positions, even when
    # they fall outside the top.
    ranked = sorted(events, key=dev_us, reverse=True)
    shown = ranked[:top] + [e for e in ranked[top:] if "knn_" in e.key]
    for e in shown:
        print(f"[profile]   {dev_us(e) / total * 100:5.1f}%  "
              f"{dev_us(e) / T / 1e3:8.4f} ms/step  x{e.count // T:<3d} "
              f"{e.key[:90]}")


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

    # Phase 2: each kernel against its plain version.
    stats = {
        "knn_fused": check_kernel("knn_fused", knn_cuda.knn_fused, 4096, 100, 4, 200),
        "knn_tiled": check_kernel("knn_tiled", knn_cuda.knn_tiled, 512, 1024, 4, 50),
    }

    # Phase 3: the k-NN swarm evaluation at full width.
    gen = torch.Generator().manual_seed(0)
    gnn = GNNActorCritic(k=4, generator=gen).to(dev).eval()
    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    # 101 steps: at T <= 100 the JAX package's last-100 window starts below 0
    # and wraps (eval.py:119); the port keeps that for parity.
    p1024 = EnvParams(num_agents=1024, obs_mode="knn", knn_k=4, max_steps=99)
    launches = {}
    got, T = run_swarm(gnn, p100, 4096, "gnn knn N=100")
    if got != {"knn_fused": T + 1, "knn_tiled": 0}:
        raise AssertionError(f"N=100 launches {got}, want fused {T + 1}")
    launches["knn_fused"] = got["knn_fused"]
    got, T = run_swarm(gnn, p1024, 512, "gnn knn N=1024")
    if got != {"knn_fused": 0, "knn_tiled": T + 1}:
        raise AssertionError(f"N=1024 launches {got}, want tiled {T + 1}")
    launches["knn_tiled"] = got["knn_tiled"]
    profile_breakdown(gnn, p100, 4096)
    profile_breakdown(gnn, p1024, 512)
    kernel_equals_plain_end_to_end(gnn, p100, 32)
    kernel_equals_plain_end_to_end(gnn, p1024.replace(max_steps=18), 4)

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

    replaces = {
        "knn_fused": "marl_distributedformation_tpu/ops/knn_pallas.py:117",
        "knn_tiled": "marl_distributedformation_tpu/ops/knn_pallas.py:155",
    }
    kernels = [
        {"name": name, "route": "cuda",
         "source": "marl_distributedformation_tpu_torch/csrc/knn.cu",
         "replaces": replaces[name], "launches": launches[name],
         **stats[name], "library_ms": None}
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
