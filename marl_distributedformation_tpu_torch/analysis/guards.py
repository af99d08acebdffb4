"""A budget on how often a program is built.

Counterpart of the JAX package's ``analysis/guards.py::RetraceGuard``. JAX
counts the traces of a jitted function: each trace compiles a new program.
The port's programs are built by hand, so the guard counts the builds: on
the card a build is the CUDA graph capture of the program's step
(``train/capture.py::PhaseGraph``), and eagerly (the CPU) it is the
construction of the eager step. A build beyond the budget raises
``RetraceError`` naming the program and the signature of what it was built
for; a build that raises does not count.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, List, Optional


class RetraceError(RuntimeError):
    """A guarded program was built more often than its budget allows."""


def describe(*args: Any) -> str:
    """The tensors and arrays in ``args`` (mappings, sequences and
    dataclasses walked) as ``dtype[shape]``, the first 8 and a count of the
    rest."""
    leaves: List[str] = []

    def walk(x: Any) -> None:
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            leaves.append(f"{x.dtype}{list(x.shape)}")
        else:
            leaves.append(f"{type(x).__name__}:{x!r}"[:40])

    walk(args)
    extra = len(leaves) - 8
    return ", ".join(leaves[:8]) + (f", … +{extra} leaves" if extra > 0
                                    else "")


class RetraceGuard:
    """Count (and optionally bound) the builds of a program.

    ``wrap(build)`` returns ``build`` counting each call as one build, and
    ``record(*signature)`` counts one where the build is not a call of its
    own (a graph capture); ``max_traces=None`` only counts.

    >>> guard = RetraceGuard("robustness_matrix_eval", max_traces=1)
    >>> build = guard.wrap(program.build)
    """

    def __init__(
        self, name: str = "program", max_traces: Optional[int] = None
    ) -> None:
        self.name = name
        self.max_traces = max_traces
        self._lock = threading.Lock()
        self.count = 0

    def reset(self) -> None:
        with self._lock:
            self.count = 0

    def record(self, *signature: Any) -> None:
        """Count one build of the program for ``signature`` (its inputs);
        raises ``RetraceError`` when the count goes over the budget."""
        with self._lock:
            self.count += 1
            count = self.count
        if self.max_traces is not None and count > self.max_traces:
            raise RetraceError(
                f"{self.name!r} built {count} times (budget "
                f"{self.max_traces}) — a shape or dtype drift is forcing "
                "a new program; offending signature: "
                f"[{describe(*signature)}]"
            )

    def wrap(self, build: Callable[..., Any]) -> Callable[..., Any]:
        """``build`` counted by ``record`` at each call, its arguments the
        signature; a call that raises is taken back."""

        @functools.wraps(build)
        def counted(*args: Any, **kwargs: Any) -> Any:
            self.record(args, kwargs)
            try:
                return build(*args, **kwargs)
            except Exception:
                # A build that raises made no program.
                with self._lock:
                    self.count -= 1
                raise

        return counted
