"""What a traffic driver hands back to the harness: the end-to-end values,
the check's numbers, and the readings the per-layer readers take their
metrics from."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Readings:
    """What one run measured, for ``layers/<metric>.py`` to read; a reader
    that finds its part missing returns None."""

    config: Dict[str, Any]
    window_s: float = 0.0
    flops: float = 0.0  # matmul FLOPs of the policy in the window
    phases: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)  # (rollout ms, update ms) an iteration
    profile: Any = None  # trace.Profile of the traced segment
    knn_shape: Optional[Tuple[int, int, int]] = None  # (M, N, k) searched
    peak_bytes: int = 0  # the allocator's peak over the run


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    numbers: Dict[str, float]  # the check's numbers, by name
    attempted: int
    failed: int
    readings: Readings
    # Diagnostics for standard error: set-up stages (seconds from the
    # process's start) and each chunk's or episode's seconds.
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


# Readers shared by metrics of one quantity in several kinds of cell
# (``layers/<name>.train.py`` and ``layers/<name>.eval.py``).

def idle_share(r: Readings) -> Optional[float]:
    """The share of the traced segment in which no operation ran on the
    device: one minus the union of the device intervals over the
    segment."""
    if r.profile is None or not r.profile.busy_us:
        return None
    return 100.0 * (1.0 - r.profile.busy_us / r.profile.window_us)


def knn_roofline(r: Readings) -> Optional[float]:
    """The k-NN kernel's least time at its shape (``roofline.knn_bound_s``)
    as a share of its mean device time a launch in the traced segment."""
    from benchmark.roofline import knn_bound_s

    if r.profile is None or r.knn_shape is None:
        return None
    launches = r.profile.kernels("knn_fused")
    if not launches:
        return None
    bound_s, _ = knn_bound_s(*r.knn_shape)
    return 100.0 * bound_s / (sum(launches) / len(launches) / 1e6)


def mfu(r: Readings) -> Optional[float]:
    """The policy's matmul FLOPs in the window (counted from its shapes by
    ``roofline.py``) over the window's time, as a share of the card's
    float32 peak."""
    from benchmark.roofline import F32_FLOPS_PER_S

    if not r.flops or not r.window_s:
        return None
    return 100.0 * r.flops / r.window_s / F32_FLOPS_PER_S
