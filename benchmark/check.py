"""The numbers the correctness check compares, each with its limit.

Training: what the program's first iterations produced (followed by the
reference, ``reference/ppo.py``), as gaps between the program's and the
reference's readings; evaluation: the episode's summary and every
formation's agents at two of its steps. Every gap is a
share of the reference's own size, so a limit means the same at every
scale. A number passes when it is at most its limit.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

from benchmark.reference.ppo import ROW_FIELDS, Record

Tensor = torch.Tensor
# A leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone and is left out of the change.
STILL_LEAF = 1e-3


def _norms(tree: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gap(got: Dict[str, Tensor], want: Dict[str, Tensor],
             leaves=None) -> Tuple[float, str]:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference leaf's norm and the median leaf's; and that leaf."""
    g, w = _norms(got), _norms(want)
    names = list(w) if leaves is None else list(leaves)
    floor = statistics.median(w[k] for k in names)
    gaps = {k: abs(g[k] - w[k]) / max(w[k], floor, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving_leaves(mu1: Dict[str, Tensor]) -> List[str]:
    """The leaves whose reference gradient (Adam's first moment after the
    first iteration) is at least ``STILL_LEAF`` of the median leaf's."""
    norms = _norms(mu1)
    floor = STILL_LEAF * statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= floor]


def rel(a: Tensor, b: Tensor) -> float:
    """``|a - b| / |b|`` in float64 norms."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def bad_perms(perms: Tensor, rows: int) -> int:
    """Epochs whose minibatch rows are not distinct rows of the rollout."""
    bad = 0
    for row in perms:
        if (row.min() < 0 or row.max() >= rows
                or torch.unique(row).numel() != row.numel()):
            bad += 1
    return bad


def train_numbers(program: Record, reference: Record) -> Dict[str, float]:
    """The training check's numbers (see ``PERF.md``): the rollout rows'
    worst relative gap, the worst iteration's loss gap, Adam's first
    moment after the first iteration by the worst leaf, the parameters'
    change by the worst moving leaf, the followed noise's distance from a
    standard normal, and the epochs whose permutations are not
    permutations."""
    rows = max(rel(p[f], r[f]) for p, r in zip(program.rows, reference.rows)
               for f in ROW_FIELDS)
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program.losses, reference.losses))
    grad, _ = leaf_gap(program.mu1, reference.mu1)
    moved_p = {k: program.params[k] - program.start[k] for k in program.start}
    moved_r = {k: reference.params[k] - reference.start[k]
               for k in reference.start}
    change, _ = leaf_gap(moved_p, moved_r, moving_leaves(reference.mu1))
    noise = 0.0
    for s, sq, count in reference.noise:
        mean = s / count
        noise = max(noise, abs(mean), abs(sq / count - mean * mean - 1.0))
    perms = sum(bad_perms(p, r["obs"].shape[0])
                for p, r in zip(program.perms, program.rows))
    return {"rows_gap": rows, "loss_gap": loss, "grad_gap": grad,
            "change_gap": change, "noise_gap": noise,
            "bad_permutations": float(perms)}


def formation_gap(got: Tensor, want: Tensor, start: Tensor) -> float:
    """The worst formation's distance between the two sides' agents
    ``(M, N, 2)``, over the larger of the distance that formation moved
    from ``start`` in the reference and the median formation's."""
    gap = torch.linalg.vector_norm((got - want).double().flatten(1), dim=1)
    moved = torch.linalg.vector_norm((want - start).double().flatten(1),
                                     dim=1)
    return float((gap / torch.maximum(moved, moved.median())
                  .clamp_min(1e-30)).max())


def eval_numbers(program, reference, start: Tensor) -> Dict[str, float]:
    """The evaluation check's numbers from each side's ``(summary, agents
    by step)``: the episode summary's worst relative gap, and at each kept
    step the worst formation's ``formation_gap`` (``formation_gap_<t>``,
    the last kept step ``formation_gap_end``)."""
    (summary, kept), (want, want_kept) = program, reference
    gap = max(abs(summary[k] - v) / max(abs(v), 1e-30)
              for k, v in want.items())
    numbers = {"episode_gap": gap}
    last = max(want_kept)
    for t, agents in want_kept.items():
        name = "end" if t == last else str(t)
        numbers[f"formation_gap_{name}"] = formation_gap(kept[t], agents,
                                                         start)
    return numbers


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """Whether every number is within its limit, and the ``(name, value,
    limit)`` triples; a number with no limit, or a limit with no number,
    fails."""
    names = sorted(set(numbers) | set(limits))
    rows = [(n, numbers.get(n, float("nan")), limits.get(n, float("nan")))
            for n in names]
    ok = all(v <= lim for _, v, lim in rows)
    return ok, rows
