"""Profiling hooks: dispatch-grained ``torch.profiler`` windows, a trace
context and a steps/s meter.

Counterpart of the JAX package's ``utils/profiling.py``. ``profile=true``
(``TrainConfig.profile``) traces ``profile_iterations`` post-warm-up
dispatches of a training run with ``torch.profiler`` (host activity, and on
the card CUDA activity, the kernels inside graph replays included) into
``{log_dir}/profile/``; under ``fused_chunk`` a dispatch is a whole chunk.
The runtime guards and the ledger's seams are re-exported here, as the JAX
package re-exports them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

from marl_distributedformation_tpu_torch.analysis.guards import (  # noqa: F401
    RetraceError,
    RetraceGuard,
    device_memory_bytes,
    ledgered_call,
    register_program,
    sample_device_watermark,
)
from marl_distributedformation_tpu_torch.obs.ledger import get_ledger
from marl_distributedformation_tpu_torch.utils.logging import (  # noqa: F401
    Throughput,
)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TraceWindow:
    """Dispatch-grained ``torch.profiler`` window for training loops (the
    ``profile=true`` implementation of the trainers).

    The unit is one dispatch: an iteration in the host loop, a whole chunk
    under ``fused_chunk``. The first ``skip`` dispatches are left out (they
    warm up and capture the graphs); the window then traces ``count``
    dispatches and closes after the card has finished them, so the trace
    holds their device work, and writes it as Chrome trace JSON
    (``trace_{pid}_{unix ms}.json``). Starting and stopping the profiler
    builds nothing: a traced run captures as often as an untraced one.

    Every completed (or aborted) window appends one JSON line to
    ``{trace_dir}/capture_ledger.jsonl``, the JAX package's audit line: the
    programs dispatched during the window (from the ledger's dispatch
    counters), the dispatches traced and skipped, and the trace directory.
    """

    AUDIT_NAME = "capture_ledger.jsonl"

    def __init__(
        self,
        log_dir: Optional[str],
        enabled: bool,
        count: int = 3,
        skip: int = 1,
    ) -> None:
        self.trace_dir = (
            os.path.join(log_dir, "profile") if log_dir else None
        )
        self.enabled = bool(enabled) and self.trace_dir is not None
        self.count = max(1, int(count))
        self.skip = max(0, int(skip))
        self._dispatches = 0
        self._traced = 0
        self.active = False
        self.captured = False
        self.trace_path: Optional[str] = None
        self.window_s: Optional[float] = None  # wall of the traced window
        self._t0 = 0.0
        self._profiler: Optional[torch.profiler.profile] = None
        self._window_baseline: Optional[dict] = None

    @staticmethod
    def _program_dispatches() -> dict:
        """``{dispatch_key: dispatches_total}`` from the ledger (empty when
        the ledger is off)."""
        suffix = "_dispatches_total"
        return {
            key[len("program_"):-len(suffix)]: value
            for key, value in get_ledger().snapshot().items()
            if key.startswith("program_") and key.endswith(suffix)
        }

    def _audit_line(self, completed: bool) -> None:
        """One line a window; never raises."""
        baseline, self._window_baseline = self._window_baseline, None
        try:
            now = self._program_dispatches()
            programs = {
                key: int(count - (baseline or {}).get(key, 0))
                for key, count in now.items()
                if count - (baseline or {}).get(key, 0) > 0
            }
            line = {
                "event": "profile_capture",
                "time": time.time(),
                "trace_dir": self.trace_dir,
                "completed": completed,
                "dispatches_traced": self._traced,
                "dispatches_skipped": self.skip,
                "programs": programs,
            }
            os.makedirs(self.trace_dir, exist_ok=True)
            with open(
                os.path.join(self.trace_dir, self.AUDIT_NAME), "a"
            ) as f:
                f.write(json.dumps(line) + "\n")
        except Exception:  # noqa: BLE001 — attribution is best-effort
            pass

    def before_dispatch(self) -> None:
        """Open the window once the warm-up dispatches have passed."""
        if (
            self.enabled
            and not self.captured
            and not self.active
            and self._dispatches >= self.skip
        ):
            self._window_baseline = self._program_dispatches()
            _synchronize()  # the window starts with the card idle
            self._profiler = torch.profiler.profile(
                activities=_activities())
            self._profiler.start()
            self._t0 = time.perf_counter()
            self.active = True
            print(f"[profile] tracing -> {self.trace_dir}")

    def after_dispatch(self) -> None:
        """Count the dispatch; once ``count`` traced dispatches are in,
        wait for the card and stop."""
        self._dispatches += 1
        if not self.active:
            return
        self._traced += 1
        if self._traced >= self.count:
            self._stop(completed=True)

    def _stop(self, completed: bool) -> None:
        _synchronize()
        self.window_s = time.perf_counter() - self._t0
        prof, self._profiler = self._profiler, None
        prof.stop()
        self.active = False
        self.captured = completed
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(
            self.trace_dir,
            f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
        self._audit_line(completed=completed)

    def close(self) -> None:
        """Teardown for error paths: stop an open window so the profiler
        session never leaks across runs."""
        if self.active:
            self._stop(completed=False)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written as Chrome trace JSON
    into ``log_dir`` (a no-op when None)."""
    if log_dir is None:
        yield
        return
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield
    finally:
        _synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))
