"""Metrics logging: one record per rollout to JSONL, stdout and optionally
wandb or tensorboard; and the trainer's throughput meter.

Counterpart of the JAX package's ``utils/logging.py`` (``MetricsLogger``) and
of ``Throughput`` in its ``utils/profiling.py``. Records are written to
``{log_dir}/metrics.jsonl`` as ``{"step", "time", **metrics}``; every 10th
record (the 1st, 11th, ...) also prints a brief line on stderr. wandb and
tensorboard are optional: when asked for and absent, a notice is printed
and the JSONL file goes on alone.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict


class MetricsLogger:
    def __init__(
        self,
        log_dir: str | Path,
        run_name: str = "run",
        use_wandb: bool = False,
        wandb_project: str = "formation-rl",
        stdout_every: int = 10,
        use_tensorboard: bool = False,
    ) -> None:
        self.log_dir = Path(log_dir)
        self.jsonl_path = self.log_dir / "metrics.jsonl"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.jsonl_path, "a", buffering=1)
        self.stdout_every = stdout_every
        self._emit_count = 0
        self._start = time.time()

        self._wandb = None
        if use_wandb:
            try:
                import wandb

                # Run naming matches the reference: "{name}-{timestamp}"
                # (vectorized_env.py:117-118).
                stamp = time.strftime("%Y-%m-%d-%H-%M")
                self._wandb = wandb.init(
                    project=wandb_project, name=f"{run_name}-{stamp}"
                )
            except Exception as e:  # noqa: BLE001 - wandb is optional
                print(f"[metrics] wandb unavailable ({e}); using JSONL only")

        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=str(self.log_dir / "tensorboard")
                )
            except Exception as e:  # noqa: BLE001 - tensorboard is optional
                print(
                    f"[metrics] tensorboard unavailable ({e}); "
                    "using JSONL only"
                )

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        """Emit one record at ``step`` (agent-transitions)."""
        record = {"step": int(step), "time": time.time() - self._start}
        for k, v in metrics.items():
            record[k] = float(v)
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=int(step))
        if self._tb is not None:
            for k, v in record.items():
                if k != "step":
                    self._tb.add_scalar(k, v, int(step))
        self._emit_count += 1
        if self.stdout_every and self._emit_count % self.stdout_every == 1:
            brief = {
                k: round(record[k], 4)
                for k in ("reward", "avg_dist_to_goal", "loss", "approx_kl")
                if k in record
            }
            print(f"[metrics] step={record['step']} {brief}", file=sys.stderr)

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """A logger that records nothing: a rank other than the coordinator's
    (the coordinator's records are the run's)."""

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        pass

    def close(self) -> None:
        pass


def run_logger(config: Any, log_dir: str | Path) -> Any:
    """A trainer's ``MetricsLogger`` for ``config`` (a ``TrainConfig``);
    a ``NullLogger`` on a rank other than the coordinator."""
    from marl_distributedformation_tpu_torch.parallel.distributed import (
        is_coordinator,
    )

    if not is_coordinator():
        return NullLogger()
    return MetricsLogger(log_dir, run_name=config.name,
                         use_wandb=config.use_wandb,
                         use_tensorboard=config.use_tensorboard)


class Throughput:
    """Steps per second over a rolling window of recent ticks. The first
    tick only starts the clock (that iteration includes warm-up: kernel
    builds, allocator growth); after it the rate is the slope over the
    last ``window`` ticks."""

    def __init__(self, window: int = 20) -> None:
        self._ticks: collections.deque = collections.deque(maxlen=window + 1)
        self._cum = 0

    def tick(self, steps: int = 1) -> None:
        if not self._ticks:
            self._ticks.append((time.perf_counter(), 0))
            return
        self._cum += steps
        self._ticks.append((time.perf_counter(), self._cum))

    def rate(self) -> float:
        if len(self._ticks) < 2:
            return 0.0
        (t0, s0), (t1, s1) = self._ticks[0], self._ticks[-1]
        if t1 <= t0:
            return 0.0
        return (s1 - s0) / (t1 - t0)
