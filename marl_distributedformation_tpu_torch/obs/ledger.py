"""ProgramLedger: per-program cost, memory and dispatch attribution.

Counterpart of the JAX package's ``obs/ledger.py``, with its census schema,
so that the JAX package's ``load_census`` and ``scripts/program_report.py``
read the port's ``program_ledger.json``. A program here is what the port
builds in place of a compiled executable: a captured CUDA graph
(``train/capture.py::PhaseGraph``) on the card, an eager build (the first
call of the step) on the CPU. Each registers once, at its build, with

- **build timings**: ``first_dispatch_seconds``, the wall of the eager
  warm-up (the CPU: the first call), and ``compile_seconds``, the capture
  with its instantiation (the card); ``trace_seconds`` and
  ``lower_seconds`` have no counterpart and stay unset;
- **graph nodes** (``graph_nodes``, the one key the census adds to JAX's;
  None for an eager build);
- **cost facts**, present or explicitly unavailable: a graph has no
  ``cost_analysis()``; ``flops`` come from ``torch.utils.flop_counter``'s
  formulas over the warm-up (``analysis_source`` "flop_counter", matmuls,
  convolutions and attention only), the memory facts are unavailable and
  ``analysis_error`` says so;
- **live dispatch-latency histograms** per program (host wall of each
  replay or eager call, after the build);
- a **device-memory watermark** sampled at drain seams
  (``torch.cuda.memory_allocated`` and ``max_memory_allocated``).

Design constraints, as the registry's: never inside a captured region,
one attribute read when disabled, and nothing but the standard library in
the record path (the torch-touching glue lives in ``analysis/guards.py``
and ``train/capture.py``).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from marl_distributedformation_tpu_torch.obs.metrics import MetricsRegistry

# Census file schema (the JAX package's load_census and
# scripts/program_report.py parse this).
CENSUS_SCHEMA = 1

# The cost/memory fact fields a record may carry. Order matters: it is
# the column order of the census and the unambiguous suffix set the
# Prometheus exporter uses to split ``program_{key}_{field}`` keys.
FACT_FIELDS = (
    "flops",
    "bytes_accessed",
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "alias_bytes",
    "generated_code_bytes",
)
TIMING_FIELDS = (
    "trace_seconds",
    "lower_seconds",
    "compile_seconds",
    "first_dispatch_seconds",
)
# How the cost facts were obtained: JAX's four sources, and the port's
# "flop_counter" (``torch.utils.flop_counter``'s formulas over the eager
# warm-up: flops only). "unavailable": none could be had, and
# ``analysis_error`` says why.
ANALYSIS_SOURCES = ("executable", "aot", "lowered", "flop_counter",
                    "unavailable")

_KEY_OK = "abcdefghijklmnopqrstuvwxyz0123456789_"


def sanitize_key(text: str) -> str:
    """A ledger/Prometheus-safe program key: lowercase ``[a-z0-9_]``."""
    out = []
    for ch in str(text).lower():
        out.append(ch if ch in _KEY_OK else "_")
    key = "".join(out).strip("_") or "program"
    while "__" in key:
        key = key.replace("__", "_")
    return key


class ProgramRecord:
    """One compiled executable's ledger entry (plain-Python facts)."""

    __slots__ = (
        "key",
        "dispatch_key",
        "name",
        "subsystem",
        "fingerprint",
        "donate_argnums",
        "backend",
        "created_unix",
        "traces",
        "analysis_source",
        "analysis_error",
        "timings",
        "facts",
        "graph_nodes",
    )

    def __init__(
        self,
        key: str,
        dispatch_key: str,
        name: str,
        subsystem: str,
        fingerprint: str,
        donate_argnums: Tuple[int, ...],
        backend: str,
        analysis_source: str,
        analysis_error: Optional[str],
        timings: Dict[str, float],
        facts: Dict[str, float],
        graph_nodes: Optional[int] = None,
    ) -> None:
        self.key = key
        self.dispatch_key = dispatch_key
        self.name = name
        self.subsystem = subsystem
        self.fingerprint = fingerprint
        self.donate_argnums = tuple(donate_argnums)
        self.backend = backend
        self.created_unix = time.time()
        self.traces = 1
        self.analysis_source = analysis_source
        self.analysis_error = analysis_error
        self.timings = dict(timings)
        self.facts = dict(facts)
        self.graph_nodes = graph_nodes

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "key": self.key,
            "dispatch_key": self.dispatch_key,
            "name": self.name,
            "subsystem": self.subsystem,
            "fingerprint": self.fingerprint,
            "donate_argnums": list(self.donate_argnums),
            "backend": self.backend,
            "created_unix": self.created_unix,
            "traces": self.traces,
            "analysis_source": self.analysis_source,
            "analysis_error": self.analysis_error,
        }
        for field in TIMING_FIELDS:
            out[field] = self.timings.get(field)
        for field in FACT_FIELDS:
            out[field] = self.facts.get(field)
        out["graph_nodes"] = self.graph_nodes
        return out


class ProgramLedger:
    """The process-global program census.

    Args:
      enabled: master switch; disabled, every record call is one
        attribute read and a return.
      reservoir: recent dispatch-latency samples retained per
        (thread, program) — the percentile window.
    """

    def __init__(self, enabled: bool = True, reservoir: int = 256) -> None:
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # key -> record, registration order preserved (dict semantics).
        self._entries: Dict[str, ProgramRecord] = {}
        # Dispatch-latency histograms ride a PRIVATE MetricsRegistry:
        # same per-thread shards, same dead-thread folding, zero new
        # concurrency code. Always-enabled internally — the gate is
        # this ledger's own ``enabled``.
        self._metrics = MetricsRegistry(
            enabled=True, reservoir=max(1, int(reservoir))
        )
        # dispatch_key -> (histogram name, counter name): the hot path
        # avoids two f-string builds per dispatch.
        # _dispatch_names stays unannotated: the dispatch hot path
        # writes it lock-free, and racing writers store an identical
        # tuple for the same key (benign by construction).
        self._dispatch_names: Dict[str, Tuple[str, str]] = {}
        self._watermark_bytes = 0.0
        self._memory_bytes = 0.0
        self._watermark_samples = 0

    # -- registration (once per compile — lock is fine) -------------------

    def register(
        self,
        *,
        name: str,
        subsystem: str,
        fingerprint: str = "",
        donate_argnums: Tuple[int, ...] = (),
        backend: str = "",
        timings: Optional[Dict[str, float]] = None,
        facts: Optional[Dict[str, float]] = None,
        analysis_source: str = "unavailable",
        analysis_error: Optional[str] = None,
        dispatch_key: Optional[str] = None,
        graph_nodes: Optional[int] = None,
    ) -> Optional[str]:
        """Register one built program; returns its ledger key (None when
        disabled). Facts and timings are plain floats, ``graph_nodes`` the
        captured graph's node count (None for an eager build)."""
        if not self.enabled:
            return None
        if analysis_source not in ANALYSIS_SOURCES:
            analysis_source = "unavailable"
        base = sanitize_key(f"{subsystem}_{name}")
        dkey = sanitize_key(dispatch_key) if dispatch_key else base
        clean_facts = {
            k: float(v)
            for k, v in (facts or {}).items()
            if k in FACT_FIELDS and v is not None
        }
        clean_timings = {
            k: float(v)
            for k, v in (timings or {}).items()
            if k in TIMING_FIELDS and v is not None
        }
        with self._lock:
            key = base
            n = 1
            while key in self._entries:
                n += 1
                key = f"{base}_{n}"
            self._entries[key] = ProgramRecord(
                key=key,
                dispatch_key=dkey,
                name=str(name),
                subsystem=str(subsystem),
                fingerprint=str(fingerprint),
                donate_argnums=tuple(donate_argnums or ()),
                backend=str(backend),
                analysis_source=analysis_source,
                analysis_error=analysis_error,
                timings=clean_timings,
                facts=clean_facts,
                graph_nodes=(None if graph_nodes is None
                             else int(graph_nodes)),
            )
        return key

    # -- hot paths --------------------------------------------------------

    def dispatch(self, dispatch_key: str, seconds: float) -> None:
        """One program dispatch's host-side wall seconds (the existing
        dispatch seam — ledgered_jit calls this around every jitted
        call). Lock-free: per-thread histogram shards."""
        if not self.enabled:
            return
        names = self._dispatch_names.get(dispatch_key)
        if names is None:
            names = (
                f"program_{dispatch_key}_dispatch_seconds",
                f"program_{dispatch_key}_dispatches_total",
            )
            self._dispatch_names[dispatch_key] = names
        self._metrics.histogram(names[0]).observe(seconds)
        self._metrics.counter(names[1]).inc()

    def record_watermark(
        self, bytes_in_use: float, peak_bytes: Optional[float] = None
    ) -> None:
        """Device-memory sample (drain/swap boundaries); the watermark
        is the max ever seen by this ledger, of the samples and of
        ``peak_bytes`` (the allocator's own peak since the last sample,
        where it keeps one)."""
        if not self.enabled:
            return
        v = float(bytes_in_use)
        top = v if peak_bytes is None else max(v, float(peak_bytes))
        with self._lock:
            self._memory_bytes = v
            self._watermark_samples += 1
            if top > self._watermark_bytes:
                self._watermark_bytes = top

    # -- read side --------------------------------------------------------

    def entries(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._entries.values())

    @property
    def watermark_bytes(self) -> float:
        return self._watermark_bytes

    @staticmethod
    def _compile_seconds(rec: ProgramRecord) -> float:
        v = rec.timings.get("compile_seconds")
        if v is None:
            # First-dispatch wall when event attribution was
            # unavailable — an upper bound rather than a silent zero.
            v = rec.timings.get("first_dispatch_seconds", 0.0)
        return float(v)

    def compile_seconds_total(self) -> float:
        """Sum of attributed backend-compile seconds over every entry."""
        return sum(self._compile_seconds(rec) for rec in self.entries())

    def compile_seconds_max(self) -> float:
        """The most expensive single program's build seconds. Unlike the
        cumulative total (which grows with every scenario-sampler rebuild
        over a long run), the max only moves when some program got more
        expensive to build."""
        return max(
            (self._compile_seconds(rec) for rec in self.entries()),
            default=0.0,
        )

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name: float}`` view for the merged Prometheus
        namespace: per-program static facts + build timings under
        ``program_{key}_{field}`` (folded into ``program``-labeled
        families by the exporter), the pooled dispatch-latency
        histograms, and the ledger aggregates."""
        if not self.enabled:
            return {}
        out: Dict[str, float] = {}
        entries = self.entries()
        for rec in entries:
            prefix = f"program_{rec.key}_"
            for field in FACT_FIELDS:
                v = rec.facts.get(field)
                if v is not None:
                    out[prefix + field] = v
            for field in TIMING_FIELDS:
                v = rec.timings.get(field)
                if v is not None:
                    out[prefix + field] = v
            out[prefix + "traces_total"] = float(rec.traces)
        out.update(self._metrics.snapshot())
        out["ledger_programs_total"] = float(len(entries))
        out["ledger_compile_seconds_total"] = self.compile_seconds_total()
        out["ledger_compile_seconds_max"] = self.compile_seconds_max()
        flops = [
            rec.facts["flops"] for rec in entries if "flops" in rec.facts
        ]
        if flops:
            out["ledger_flops_total"] = float(sum(flops))
        if self._watermark_samples:
            out["device_memory_bytes_in_use"] = self._memory_bytes
            out["device_memory_watermark_bytes"] = self._watermark_bytes
        return out

    def census(self) -> Dict[str, Any]:
        """The structured program census: every entry's full record plus
        the dispatch-latency summaries and the ledger totals (the file
        ``write_census`` writes)."""
        entries = self.entries()
        hists = self._metrics.snapshot()
        programs = []
        for rec in entries:
            d = rec.as_dict()
            h = f"program_{rec.dispatch_key}_dispatch_seconds"
            for q in ("p50", "p95", "p99", "count", "sum"):
                d[f"dispatch_seconds_{q}"] = hists.get(f"{h}_{q}")
            d["dispatches_total"] = hists.get(
                f"program_{rec.dispatch_key}_dispatches_total"
            )
            programs.append(d)
        return {
            "schema": CENSUS_SCHEMA,
            "created_unix": time.time(),
            "enabled": self.enabled,
            "programs": programs,
            "totals": {
                "programs": len(entries),
                "traces": sum(rec.traces for rec in entries),
                "compile_seconds": self.compile_seconds_total(),
                "flops": sum(
                    rec.facts.get("flops", 0.0) for rec in entries
                ),
                "watermark_bytes": (
                    self._watermark_bytes
                    if self._watermark_samples
                    else None
                ),
            },
        }

    def write_census(self, path: "str | Path") -> Path:
        """Atomic census dump (``logs/{name}/program_ledger.json`` —
        the file the census diff gate and program_report read)."""
        target = Path(path)
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name("." + target.name + ".tmp")
        tmp.write_text(json.dumps(self.census(), indent=2, sort_keys=True))
        tmp.replace(target)
        return target


# ----------------------------------------------------------------------
# Process-global ledger
# ----------------------------------------------------------------------

_default_ledger = ProgramLedger()


def get_ledger() -> ProgramLedger:
    """The process-global ledger every compile seam resolves at call
    time."""
    return _default_ledger


def set_ledger(ledger: ProgramLedger) -> ProgramLedger:
    """Swap the process-global ledger (tests); returns the previous
    one."""
    global _default_ledger
    previous = _default_ledger
    _default_ledger = ledger
    return previous


def configure_ledger(
    enabled: Optional[bool] = None, reservoir: Optional[int] = None
) -> ProgramLedger:
    """Re-shape the process-global ledger in place (the entry points'
    ``ledger`` / ``ledger_reservoir`` knobs)."""
    ledger = get_ledger()
    if enabled is not None:
        ledger.enabled = bool(enabled)
    if reservoir is not None:
        ledger._metrics.reservoir = max(1, int(reservoir))
    return ledger


def merge_ledger_snapshot(base: Dict[str, Any]) -> Dict[str, Any]:
    """Overlay the process-global ledger's families onto ``base``, in
    place: the one merge point of the TelemetryServer's scrape.
    Failure-isolated: observability never breaks the scrape that reads
    it."""
    try:
        base.update(get_ledger().snapshot())
    except Exception:  # noqa: BLE001
        pass
    return base


def load_census(path: "str | Path") -> Dict[str, Any]:
    """Read a census file back, validating the schema envelope."""
    data = json.loads(Path(path).read_text())
    if not isinstance(data, dict) or "programs" not in data:
        raise ValueError(f"{path}: not a program-ledger census")
    schema = data.get("schema")
    if schema != CENSUS_SCHEMA:
        raise ValueError(
            f"{path}: census schema {schema!r} (this reader speaks "
            f"{CENSUS_SCHEMA})"
        )
    return data
