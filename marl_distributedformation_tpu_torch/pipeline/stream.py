"""CheckpointStream: tail a trainer's checkpoint directory, cheaply.

Counterpart of the JAX package's ``pipeline/stream.py``.

The trainer (host-loop or Anakin fused-scan) drops
``rl_model_{steps}_steps.msgpack`` files into ``logs/{name}/`` — each
one written to a dot-prefixed temp name and atomically renamed
(``utils.checkpoint.write_atomic``), so the rename IS the publication
anchor: a discovered file is always complete, a torn write is never
visible (the population sweeps extend the same convention with a
``sweep_state`` anchor written last). The stream therefore never needs
content-level handshakes — it only has to notice new names, in step
order, without re-paying discovery for every historic checkpoint on
every poll (``utils.checkpoint.CheckpointDiscovery`` is the incremental
engine: idle polls are one ``stat``, active polls parse only unseen
names).

``nudge()`` is the push path: the trainer's ``on_checkpoint`` hook
(called on the async writer thread AFTER the rename lands) wakes a
blocked ``wait()`` immediately, so promotion latency is not floored at
the poll interval.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, List, Optional

from marl_distributedformation_tpu_torch.chaos.plane import fault_point
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CheckpointDiscovery,
)


class CheckpointStream:
    """Consuming, step-ordered view of a checkpoint directory.

    Each checkpoint is yielded exactly once, in ascending step order;
    steps at or below the consumed high-water mark are ignored (the
    registry's never-go-backward semantics). ``start_after_step`` skips
    history — e.g. resume a pipeline without re-gating already-judged
    candidates.
    """

    def __init__(
        self,
        log_dir: str | Path,
        poll_interval_s: float = 0.25,
        start_after_step: int = -1,
    ) -> None:
        self.log_dir = Path(log_dir)
        self.poll_interval_s = poll_interval_s
        self._discovery = CheckpointDiscovery(
            self.log_dir, start_after_step=start_after_step
        )
        self._nudge = threading.Event()

    def nudge(self, path: Optional[Any] = None) -> None:
        """Wake a blocked :meth:`wait` now (signature-compatible with
        ``Trainer.on_checkpoint``; the path is advisory — discovery
        stays the single source of truth)."""
        del path
        self._nudge.set()

    def poll(self) -> List[Path]:
        """New checkpoints since the last poll, ascending step order.
        Non-blocking."""
        fault_point("stream.poll")
        return self._discovery.poll_new()

    def wait(self, timeout_s: float) -> List[Path]:
        """Block until at least one new checkpoint appears or
        ``timeout_s`` elapses; returns possibly-empty list. A trainer
        ``nudge`` short-circuits the poll interval."""
        deadline = time.monotonic() + timeout_s
        while True:
            fresh = self.poll()
            if fresh:
                return fresh
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            self._nudge.wait(min(self.poll_interval_s, remaining))
            self._nudge.clear()
