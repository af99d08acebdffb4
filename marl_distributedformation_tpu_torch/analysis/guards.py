"""A budget on how often a program is built, and the ledger's build seam.

Counterpart of the JAX package's ``analysis/guards.py`` (``RetraceGuard``,
``ledgered_jit``, ``sample_device_watermark``). JAX counts the traces of a
jitted function: each trace compiles a new program. The port's programs
are built by hand, so the guard counts the builds: on the card a build is
the CUDA graph capture of the program's step
(``train/capture.py::PhaseGraph``), and eagerly (the CPU) it is the
construction of the eager step. A build beyond the budget raises
``RetraceError`` naming the program and the signature of what it was built
for; a build that raises does not count.

Where JAX's ``ledgered_jit`` registers each compiled executable in the
program ledger (``obs/ledger.py``), the port registers each build at the
point where it is counted: a ``PhaseGraph`` at its capture (the CPU: its
first call) through :func:`register_program`, an eager host function
through :func:`ledgered_call`. :func:`sample_device_watermark` records the
device-memory watermark at drain seams.

The runtime guards of ``train.TrainConfig`` (``guard_retraces``,
``guard_transfers``, ``guard_nans``) are a budget on a ``RetraceGuard``,
:func:`no_host_transfers` (the CUDA sync debug mode) and :func:`nan_guard`
(a dispatch mode naming the op that made a NaN).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from marl_distributedformation_tpu_torch.obs.ledger import (
    get_ledger,
    sanitize_key,
)


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
    own (a graph capture); ``max_traces=None`` only counts. With a
    ``subsystem`` the program it guards registers in the ledger under the
    guard's name (``train/capture.py::PhaseGraph`` does it at the build).

    >>> guard = RetraceGuard("robustness_matrix_eval", max_traces=1)
    >>> build = guard.wrap(program.build)
    """

    def __init__(
        self, name: str = "program", max_traces: Optional[int] = None,
        subsystem: Optional[str] = None,
    ) -> None:
        self.name = name
        self.max_traces = max_traces
        # The ledger's subsystem of the program this guard counts (its
        # name is the program's); None registers nothing.
        self.subsystem = subsystem
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


# ----------------------------------------------------------------------
# The program ledger's build seam
# ----------------------------------------------------------------------

MEMORY_FACTS_UNAVAILABLE = (
    "a CUDA graph or an eager step has no cost_analysis(): argument, "
    "output, temp, alias and code bytes are not known"
)


def _flop_mode():
    """A dispatch mode that adds up ``torch.utils.flop_counter``'s formulas
    (matmuls, convolutions, attention; elementwise work counts nothing)
    over every op it sees. ``FlopCounterMode`` itself tracks modules with
    autograd hooks that ``torch.autograd.grad`` refuses, so the port counts
    with its formula table alone."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopCount(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += int(formula(*args, **kwargs, out_val=out))
            return out

    return FlopCount()


def counted_run(fn: Callable[[], Any]) -> Tuple[Any, float, Dict[str, float],
                                                str, Optional[str]]:
    """Run ``fn()`` once as a program's build run: ``(result, wall
    seconds, facts, analysis_source, analysis_error)``. With the ledger on,
    the run goes under a FLOP-counting dispatch mode (``_flop_mode``),
    whose total becomes the ``flops`` fact."""
    facts: Dict[str, float] = {}
    if not get_ledger().enabled:
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, facts, "unavailable", None
    counter = _flop_mode()
    t0 = time.perf_counter()
    with counter:
        out = fn()
    wall = time.perf_counter() - t0
    facts["flops"] = float(counter.total)
    return out, wall, facts, "flop_counter", MEMORY_FACTS_UNAVAILABLE


def register_program(
    *,
    name: str,
    subsystem: str,
    signature: tuple = (),
    timings: Optional[Dict[str, float]] = None,
    facts: Optional[Dict[str, float]] = None,
    analysis_source: str = "unavailable",
    analysis_error: Optional[str] = None,
    graph_nodes: Optional[int] = None,
    device: Any = None,
) -> Optional[str]:
    """Register one build in the process-global ledger: the port's side of
    JAX's ``ledgered_jit`` registration. ``signature`` (the tensors the
    program was built for) becomes the fingerprint. Returns the ledger key
    (None when the ledger is off); never raises."""
    ledger = get_ledger()
    if not ledger.enabled:
        return None
    try:
        return ledger.register(
            name=name,
            subsystem=subsystem,
            fingerprint=describe(*signature),
            backend=str(getattr(device, "type", device) or ""),
            timings=timings,
            facts=facts,
            analysis_source=analysis_source,
            analysis_error=analysis_error or (
                "no cost analysis of this program"
                if analysis_source == "unavailable" else None),
            dispatch_key=dispatch_key_of(subsystem, name),
            graph_nodes=graph_nodes,
        )
    except Exception:  # noqa: BLE001 — observability never fails a build
        return None


def dispatch_key_of(subsystem: str, name: str) -> str:
    """The ledger's dispatch key of a program (its histogram's name)."""
    return sanitize_key(f"{subsystem}_{name}")


def ledgered_call(
    fn: Callable[..., Any],
    guard: RetraceGuard,
    *,
    subsystem: str,
    program: Optional[str] = None,
) -> Callable[..., Any]:
    """``fn``, an eager host program, with JAX's ``ledgered_jit`` receipts:
    its first call is its build, counted by ``guard`` and registered in the
    ledger (the call's wall as ``first_dispatch_seconds``); every later
    call records its wall as a dispatch."""
    name = program or getattr(fn, "__name__", None) or "program"
    key = dispatch_key_of(subsystem, name)
    built: List[bool] = []

    @functools.wraps(fn)
    def call(*args: Any, **kwargs: Any) -> Any:
        if not built:
            guard.record(args, kwargs)
            out, wall, facts, source, error = counted_run(
                lambda: fn(*args, **kwargs))
            built.append(True)
            register_program(
                name=name, subsystem=subsystem, signature=(args, kwargs),
                timings={"first_dispatch_seconds": wall}, facts=facts,
                analysis_source=source, analysis_error=error, device="cpu",
            )
            return out
        ledger = get_ledger()
        if not ledger.enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        ledger.dispatch(key, time.perf_counter() - t0)
        return out

    return call


def device_memory_bytes() -> Optional[Tuple[float, float]]:
    """``(in use, peak)`` bytes of the current CUDA device's caching
    allocator (``torch.cuda.memory_allocated`` and
    ``max_memory_allocated``); None without an initialised card (the CPU
    has no device memory to sample)."""
    import torch

    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        return (float(torch.cuda.memory_allocated()),
                float(torch.cuda.max_memory_allocated()))
    except Exception:  # noqa: BLE001 — a gauge, not a contract
        return None


_watermark_lock = threading.Lock()
_watermark_last = 0.0


def sample_device_watermark(
    min_interval_s: float = 5.0, force: bool = False
) -> Optional[float]:
    """Record the device-memory footprint into the ledger's watermark
    gauge, at a drain seam (a host seam where a sync just happened); one
    attribute read when the ledger is off. Samples closer than
    ``min_interval_s`` are skipped unless ``force``. Returns the bytes in
    use, or None."""
    global _watermark_last
    ledger = get_ledger()
    if not ledger.enabled:
        return None
    now = time.monotonic()
    with _watermark_lock:
        if not force and now - _watermark_last < min_interval_s:
            return None
        _watermark_last = now
    value = device_memory_bytes()
    if value is None:
        return None
    ledger.record_watermark(value[0], peak_bytes=value[1])
    return value[0]


# ----------------------------------------------------------------------
# Runtime guards: host syncs and NaNs inside a dispatch
# ----------------------------------------------------------------------

# JAX's ``transfer_guard`` levels and the sync debug modes they map to.
_SYNC_LEVELS = {"disallow": "error", "log": "warn"}


@contextlib.contextmanager
def no_host_transfers(level: str = "disallow") -> Iterator[None]:
    """Forbid the calls that wait for the card inside the wrapped region:
    ``torch.cuda.set_sync_debug_mode`` at ``level`` ("disallow"/"error"
    raises, "log"/"warn" warns), restored on exit.

    It catches what synchronizes the host with the device: ``.item()``,
    ``float()`` of a device tensor, a copy to pageable host memory,
    ``nonzero``. An asynchronous copy into pinned memory does not
    synchronize and passes, where JAX's guard refuses every
    device-to-host transfer. The mode is the process's, not the
    thread's: every thread that synchronizes meanwhile raises too, so a
    caller guards a region that no other lane runs beside. Without a
    CUDA device there is nothing to wait for and the guard is a no-op,
    as JAX's is on its CPU backend."""
    import torch

    mode = _SYNC_LEVELS[level]
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def _nan_check_mode():
    """A dispatch mode that raises ``FloatingPointError`` naming the first
    aten op on tensors whose floating-point output holds a NaN. An op with
    no tensor input (``scalar_tensor``, ``full``) makes a constant, not a
    result: a NaN fill there is a literal, as in JAX, where
    ``jax_debug_nans`` checks primitives' outputs and not constants."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class NanCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not any(isinstance(a, torch.Tensor)
                       for a in tree_leaves((args, kwargs))):
                return out
            for t in tree_leaves(out):
                if not (isinstance(t, torch.Tensor)
                        and t.is_floating_point()):
                    continue
                # graftlint: disable=host-nonfinite-probe-in-dispatch-loop per-op probe is nan_guard's purpose
                if bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func} "
                        f"(output {t.dtype}{list(t.shape)})"
                    )
            return out

    return NanCheck()


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Eager ops in the wrapped region raise ``FloatingPointError`` at the
    first op whose output holds a NaN, naming it (JAX's scoped
    ``jax_debug_nans``). A captured graph's replay runs no op the mode can
    see: the trainer reads a NaN flag after a guarded dispatch and re-runs
    it eagerly under this guard (``train/trainer.py``)."""
    if not enable:
        yield
        return
    with _nan_check_mode():
        yield
