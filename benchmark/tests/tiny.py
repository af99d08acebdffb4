"""A copy of the benchmark with tiny cells, for the CPU tests: the same
drivers, readers and reference, found by name from files in a temporary
directory, exactly as the harness finds the real cells."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

# Tiny cells' own limits: their samples are small (the noise statistic
# over a few hundred draws), so the real cells' limits do not apply.
TRAIN_LIMITS = {"rows_gap": 5e-6, "loss_gap": 1e-6, "grad_gap": 5e-4,
                "change_gap": 2e-5, "noise_gap": 0.5, "bad_permutations": 0}
EVAL_LIMITS = {"episode_gap": 4e-7, "formation_gap_end": 1e-6}


def tiny_configs():
    """A 6-agent k-NN GNN and an 8-formation ring MLP, each trained in
    chunks of 3 iterations, and the GNN's episodes cut to 22 steps."""
    gnn = harness.load_json(harness.HERE / "configs" / "gnn100.json")
    gnn["name"] = "tinygnn"
    gnn["overrides"] = ["name=bench_test_gnn", "policy=gnn", "obs_mode=knn",
                        "knn_k=2", "num_agents_per_formation=6",
                        "num_formation=4", "batch_size=60", "fused_chunk=3"]
    gnn["env"].update(num_agents=6, knn_k=2)
    gnn["model"]["knn_k"] = 2
    gnn["ppo"]["batch_size"] = 60
    gnn.update(num_formations=4, fused_chunk=3)
    ring = harness.load_json(harness.HERE / "configs" / "ring5.json")
    ring["name"] = "tinyring"
    ring["overrides"] = ["name=bench_test_ring", "policy=mlp",
                         "obs_mode=ring", "num_agents_per_formation=5",
                         "num_formation=8", "batch_size=64", "fused_chunk=3"]
    ring["ppo"]["batch_size"] = 64
    ring.update(num_formations=8, fused_chunk=3)
    short = json.loads(json.dumps(gnn))
    short["name"] = "tinyshort"
    short["overrides"].append("max_steps=20")
    short["env"]["max_steps"] = 20
    return {"tinygnn": gnn, "tinyring": ring, "tinyshort": short}


def make_bench(tmp: Path) -> Path:
    """``tmp/benchmark`` (a copy of the benchmark) with the tiny cells
    ``tinygnn.train``, ``tinyring.train`` and ``tinyshort.eval``, and
    ``tmp/BENCHMARK.json`` naming them; returns the spec's path."""
    dst = tmp / "benchmark"
    shutil.copytree(harness.HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    configs = tiny_configs()
    spec["configs"] = []
    for name, config in configs.items():
        path = dst / "configs" / f"{name}.json"
        path.write_text(json.dumps(config))
        spec["configs"].append({"name": name, "source": config["source"],
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "a CPU test"})
    (dst / "traffic" / "eval_tiny.json").write_text(
        json.dumps({"kind": "eval", "num_formations": 4}))
    cells = {"tinygnn.train": ("tinygnn", "train", TRAIN_LIMITS),
             "tinyring.train": ("tinyring", "train", TRAIN_LIMITS),
             "tinyshort.eval": ("tinyshort", "eval_tiny", EVAL_LIMITS)}
    spec["workloads"] = []
    for cell, (config, traffic, limits) in cells.items():
        (dst / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a CPU test"})
    kinds = {"train": ["tinygnn.train", "tinyring.train"],
             "eval": ["tinyshort.eval"]}
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            kind = "eval" if metric["name"].startswith("eval") or \
                metric["name"].endswith(".eval") else "train"
            metric["workloads"] = kinds[kind]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


def cell(spec: Path, name: str) -> harness.Cell:
    return harness.Cell(name, bench_dir=spec.parent / "benchmark",
                        spec_path=spec)
