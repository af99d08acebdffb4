#!/usr/bin/env python3
"""What the deterministic GNN gather costs, on the card (ROADMAP C4).

    python3 scripts/port_c4_cost.py [iterations]

Trains ``gnn100``'s command (``docs/acceptance/gnn100``: N=100, M=1024,
k=4, ``preset=tpu``; ``iterations`` of them, 5 by default) and
``gnn1024``'s (N=1024, M=8; three times as many iterations) through the
port's ``train`` CLI with the iteration captured, six times each in one
process, with three backwards of the GNN's neighbor gather in the order
port, atomic, other, other, atomic, port:

- ``port``: the one the port ships (``models/gnn.py::_GatherNodes``): a
  one-hot GEMM up to ``ONE_HOT_MAX_N`` agents, a sorted segment sum above;
- ``atomic``: ``torch.gather``'s own ``scatter_add``, with atomics (the
  backward before the repair);
- ``other``: the deterministic form the port does not pick at that N (the
  sorted segment sum at N=100, the one-hot GEMM at N=1024).

Prints each run's steady s/iteration (CUDA events, the two building
iterations left out), each backward's mean and its cost against
``atomic``, and whether the two runs of each ended on the same parameters
bitwise. The card's name and power limit are printed first and last.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _flat(h, idx):
    n, k = idx.shape[-2], idx.shape[-1]
    return idx.reshape(*idx.shape[:-2], n * k, 1).expand(
        *idx.shape[:-2], n * k, h.shape[-1])


def atomic_gather(h, idx):
    import torch

    n, k = idx.shape[-2], idx.shape[-1]
    out = torch.gather(h, -2, _flat(h, idx))
    return out.reshape(*idx.shape[:-2], n, k, h.shape[-1])


def compare(label, command, n):
    """Six runs of ``command``; returns nothing, prints the means."""
    import torch

    from marl_distributedformation_tpu_torch.models import gnn

    port, threshold = gnn.gather_nodes, gnn.ONE_HOT_MAX_N
    other = "sorted" if n <= threshold else "onehot"
    # (gather, ONE_HOT_MAX_N) a kind: the backward's form is chosen when
    # the minibatch phase is built, so it holds for the whole run.
    gathers = {"port": (port, threshold),
               "atomic": (atomic_gather, threshold),
               other: (port, math.inf if other == "onehot" else 0)}
    results = {kind: [] for kind in gathers}
    try:
        for kind in ("port", "atomic", other, other, "atomic", "port"):
            gnn.gather_nodes, gnn.ONE_HOT_MAX_N = gathers[kind]
            trainer, _, _, s_iter = cs.train_run(
                f"c4_{n}_{kind}", command, f"{label}, {kind} gather "
                "backward")
            params = [p.detach().clone() for p in trainer.model.parameters()]
            results[kind].append((s_iter, params))
            del trainer
    finally:
        gnn.gather_nodes, gnn.ONE_HOT_MAX_N = port, threshold
    means = {k: sum(s for s, _ in v) / len(v) for k, v in results.items()}
    for kind in ("port", other):
        print(f"[c4] {label} s/iteration: {kind} "
              f"{[round(s, 4) for s, _ in results[kind]]} mean "
              f"{means[kind]:.4f}; atomic "
              f"{[round(s, 4) for s, _ in results['atomic']]} mean "
              f"{means['atomic']:.4f}; cost "
              f"{100 * (means[kind] / means['atomic'] - 1):+.2f}%")
    for kind, runs in results.items():
        same = all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        print(f"[c4] {label} {kind} gather: two runs from one seed end on "
              f"the same parameters bitwise: {same}")


def main() -> int:
    import torch

    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda

    if not torch.cuda.is_available():
        print("port_c4_cost: no CUDA device", file=sys.stderr)
        return 2
    iterations = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    print(cs.card_line())
    _build.build([knn_cuda.SOURCE])
    compare(f"gnn100 {iterations} iterations", cs.GNN100[:-1] + (
        f"total_timesteps={iterations * 10 * 1024 * 100}",), 100)
    compare(f"gnn1024 {3 * iterations} iterations", cs.GNN1024[:-1] + (
        f"total_timesteps={3 * iterations * 10 * 8 * 1024}",), 1024)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
