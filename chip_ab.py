#!/usr/bin/env python3
"""Times one cell of ``chip_smoke.py`` on one NVIDIA GPU in several trees
of this repo, to compare two versions of the port on one card:

    python3 chip_ab.py TREE [TREE ...]
    python3 chip_ab.py --cell always100 TREE [TREE ...]
    python3 chip_ab.py --cell dp100x2 [--plant NAME] [--override KEY=VALUE]
        TREE [TREE ...]

Each tree runs in a process of its own, in the order given (put the two
versions as A, B, B, A to see the card drift), through the tree's own
``chip_smoke.py``:

- ``gnn100`` (the default): ``chip_smoke.train_run`` runs
  ``chip_smoke.GNN100`` (N=100, M=1024, k=4, ``preset=tpu``) for
  ``--iterations`` iterations with the iteration captured, and its steady
  seconds an iteration (CUDA events around the phases, the warm-up and
  capture iterations left out) is printed;
- ``always100``: ``chip_smoke.always100`` runs the always-learning
  pipeline (its trainer, the gate's matrix program, the R=2 fleet under
  two clients), and the pipeline's promotion latency p50 and p95, the
  p50 of its gate stage (``gate_eval_s``) and ``gate_eval_steps_per_sec``
  are printed;
- ``dp100x2``: ``chip_smoke.train_run`` runs ``gnn100`` for 3 iterations,
  keeping its parameters, then ``chip_smoke.dp100x2`` runs the same
  command at ``mesh={dp: 2}`` in two ranks on the card and holds it
  against them: each leaf's drift after 2 iterations, the gate's verdict
  (a failed gate is reported, not raised) and both runs' seconds an
  iteration are printed. ``--override`` adds train overrides to both runs
  (``clip_range=1000000.0`` takes the ratio clip out of reach);
  ``--plant`` plants a fault in the ranks' loss
  (``chip_smoke.plant_fault``), to show the gate failing.

The last line is one JSON object: the card's name and power limit
(``nvidia-smi``) and, per run, the tree and its numbers. The logs go under
each tree's ``logs/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as smoke
overrides = [o for o in smoke.GNN100 if not o.startswith("total_timesteps=")]
overrides.append(f"total_timesteps={int(sys.argv[2]) * 1024000}")
t0 = time.perf_counter()
trainer, _, launches, s_iter = smoke.train_run("ab_gnn100", overrides,
                                               "gnn100 A/B")
wall = time.perf_counter() - t0
steady = trainer.smoke_phase_ms[smoke.WARM_ITERATIONS[True]:]
print(json.dumps({
    "s_iter": s_iter,
    "rollout_s": sum(r for r, _ in steady) / len(steady) / 1e3,
    "update_s": sum(u for _, u in steady) / len(steady) / 1e3,
    "iterations": len(trainer.smoke_phase_ms), "wall_s": wall,
    "launches": launches}))
"""
DP_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as smoke
from marl_distributedformation_tpu_torch.ops import _build, knn_cuda
plant, extra = sys.argv[2] or None, tuple(sys.argv[3:])
_build.build([knn_cuda.SOURCE])
kept = {}
_, rewards, _, s_iter = smoke.train_run(
    "ab_gnn100", smoke.GNN100[:-1] + ("total_timesteps=3072000",) + extra,
    "gnn100 reference, 3 iterations",
    before_train=lambda t: kept.update(params=smoke.keep_params(t, (1, 2))))
gnn100 = {"rewards": rewards, "s_iter": s_iter, "params_at": kept["params"]}
kwargs = {"plant": plant, "extra": extra} if plant or extra else {}
try:
    launches, dp_s_iter = smoke.dp100x2(gnn100, **kwargs)
    gate = "passed"
except AssertionError as e:
    launches, dp_s_iter, gate = None, None, f"failed: {e}"
print(json.dumps({"gnn100_s_iter": s_iter, "s_iter": dp_s_iter,
                  "launches": launches, "gate": gate, "plant": plant,
                  "overrides": list(extra)}))
"""
ALWAYS_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as smoke
from marl_distributedformation_tpu_torch import always_learning
main = always_learning.main
got = {}
def run(*args, **kwargs):
    got["report"] = main(*args, **kwargs)
    return got["report"]
always_learning.main = run
rows, _ = smoke.serve_rows()
t0 = time.perf_counter()
# always100 reads gnn100's s/iteration only for its printed ratio.
smoke.always100({"s_iter": float("nan"), "ckpt": None}, rows)
wall = time.perf_counter() - t0
report = got["report"]
print(json.dumps({
    "promotion_latency_s_p50": report["promotion_latency_s_p50"],
    "promotion_latency_s_p95": report["promotion_latency_s_p95"],
    "gate_eval_s_p50": report["promotion_span_breakdown"].get("gate_eval_s"),
    "gate_eval_steps_per_sec": report["gate_eval_steps_per_sec"],
    "promotions": report["promotions"], "wall_s": wall}))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--iterations", type=int, default=20)
    parser.add_argument("--cell", choices=("gnn100", "always100", "dp100x2"),
                        default="gnn100")
    parser.add_argument("--plant", choices=("share", "advnorm"), default="")
    parser.add_argument("--override", action="append", default=[])
    args = parser.parse_args()
    child = {"gnn100": [CHILD, str(args.iterations)],
             "always100": [ALWAYS_CHILD],
             "dp100x2": [DP_CHILD, args.plant, *args.override]}[args.cell]
    card = card_line()
    print(card)
    runs = []
    for tree in args.trees:
        tree = tree.resolve()
        if not (tree / "chip_smoke.py").is_file():
            print(f"chip_ab: no chip_smoke.py in {tree}", file=sys.stderr)
            return 2
        out = subprocess.run(
            [sys.executable, "-c", child[0], str(tree), *child[1:]],
            cwd=tree, capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(out.stdout[-4000:])
            print(f"chip_ab: {tree} failed with {out.returncode}",
                  file=sys.stderr)
            return 1
        lines = out.stdout.strip().splitlines()
        print("\n".join(line for line in lines
                        if line.startswith(("[train]", "[always]", "[dp]"))))
        run = {"tree": str(tree), "cell": args.cell, **json.loads(lines[-1])}
        if args.cell == "gnn100":
            print(f"[ab] {tree.name}: {run['s_iter']:.4f} s/iteration "
                  f"(rollout {run['rollout_s']:.4f} + update "
                  f"{run['update_s']:.4f}), {run['iterations']} iterations "
                  f"in {run['wall_s']:.1f} s")
        elif args.cell == "dp100x2":
            print(f"[ab] {tree.name}: dp100x2 {run['s_iter']} s/iteration "
                  f"(gnn100 {run['gnn100_s_iter']:.4f}), plant "
                  f"{run['plant']}, overrides {run['overrides']}; gate "
                  f"{run['gate']}")
        else:
            print(f"[ab] {tree.name}: always100 promotion p50 "
                  f"{run['promotion_latency_s_p50']} s, p95 "
                  f"{run['promotion_latency_s_p95']} s, gate stage p50 "
                  f"{run['gate_eval_s_p50']} s, gate "
                  f"{run['gate_eval_steps_per_sec']} formation-steps/s, "
                  f"{run['promotions']} promotions, in {run['wall_s']:.1f} s")
        runs.append(run)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
