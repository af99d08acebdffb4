"""MetricsRegistry: the live-metrics plane every subsystem records into.

Counterpart of the JAX package's ``obs/metrics.py``, the same semantics and
the same snapshot keys: one process-global registry of counters, gauges and
bounded-reservoir histograms, recorded from every lane (the trainer's
dispatch loop and drain, the checkpoint writer, the recovery ladder, the
Sebulba lanes, the continuous adversary) and rendered as one Prometheus
namespace by :func:`~.export.prometheus_exposition`
(:class:`TelemetryServer`, ``GET /metrics``).

Design constraints, in order:

1. **Never inside a captured region.** Recording happens at host seams
   only (between graph replays, at drains), never in a function that a
   CUDA graph captures: a capture would run it once and no replay would.
2. **Lock-cheap.** Each recording thread owns its own shard (plain
   dict/deque mutations are GIL-atomic); the only lock is taken once per
   thread at shard registration and once per ``snapshot()`` merge.
3. **Bounded memory.** Histograms keep a bounded reservoir of recent
   samples per thread (percentiles are over the recent window) plus exact
   ``count``/``sum``; counters and gauges are one float per (thread,
   name).

Snapshots are flat ``{name: float}`` dicts, with histograms flattened to
``{name}_p50/_p95/_p99/_count/_sum``. ``*_total`` names render as
Prometheus counters, percentile triples fold into ``summary`` families
with ``quantile`` labels (``export.py``).

The process-global registry: :func:`get_registry` / :func:`set_registry` /
:func:`configure_metrics`. Disabled, every record call is one attribute
read and a return, so instrumentation stays wired in unconditionally.
Imports nothing but the standard library.
"""

from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple


class _HistShard:
    """One thread's slice of one histogram: bounded recent samples plus
    exact lifetime count/sum."""

    __slots__ = ("samples", "count", "sum")

    def __init__(self, reservoir: int) -> None:
        self.samples: deque = deque(maxlen=reservoir)
        self.count = 0
        self.sum = 0.0


class _Shard:
    """One thread's private slice of the registry. Mutated only by its
    owning thread; read (never written) by ``snapshot()``."""

    __slots__ = ("counters", "gauges", "hists", "reservoir")

    def __init__(self, reservoir: int) -> None:
        self.counters: Dict[str, float] = {}
        # name -> (seq, value): the global seq makes last-write-wins
        # well-defined when several threads set the same gauge.
        self.gauges: Dict[str, Tuple[int, float]] = {}
        self.hists: Dict[str, _HistShard] = {}
        self.reservoir = reservoir


class Counter:
    """Monotone accumulator handle. Name it ``*_total`` to render as a
    Prometheus counter; callers may cache the handle or re-mint it per
    call (both are cheap)."""

    __slots__ = ("_registry", "name")

    def __init__(self, registry: "MetricsRegistry", name: str) -> None:
        self._registry = registry
        self.name = name

    def inc(self, n: float = 1.0) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        counters = reg._shard().counters
        counters[self.name] = counters.get(self.name, 0.0) + n


class Gauge:
    """Point-in-time value handle; last write (across all threads) wins
    at snapshot."""

    __slots__ = ("_registry", "name")

    def __init__(self, registry: "MetricsRegistry", name: str) -> None:
        self._registry = registry
        self.name = name

    def set(self, value: float) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        reg._shard().gauges[self.name] = (next(reg._seq), float(value))


class Histogram:
    """Bounded-reservoir distribution handle; snapshot reports
    p50/p95/p99 over the recent window plus exact count/sum."""

    __slots__ = ("_registry", "name")

    def __init__(self, registry: "MetricsRegistry", name: str) -> None:
        self._registry = registry
        self.name = name

    def observe(self, value: float) -> None:
        reg = self._registry
        if not reg.enabled:
            return
        shard = reg._shard()
        hist = shard.hists.get(self.name)
        if hist is None:
            hist = shard.hists[self.name] = _HistShard(shard.reservoir)
        value = float(value)
        hist.samples.append(value)
        hist.count += 1
        hist.sum += value


class MetricsRegistry:
    """Per-thread metric shards merged at snapshot time.

    Args:
      enabled: master switch; disabled handles are no-ops (one attribute
        read per call), so instrumentation stays wired unconditionally.
      reservoir: recent samples retained per (thread, histogram) —
        percentiles are over this window.
    """

    def __init__(self, enabled: bool = True, reservoir: int = 512) -> None:
        self.enabled = bool(enabled)
        self.reservoir = max(1, int(reservoir))
        self._local = threading.local()
        self._shards_lock = threading.Lock()
        # thread ident -> shard. Read by snapshot().
        self._shards: Dict[int, _Shard] = {}
        # Dead threads' shards FOLD into these accumulators (on ident
        # recycling, reservoir resize, or the periodic dead-thread sweep
        # in _shard) instead of queueing whole shards: counter totals
        # and histogram count/sum are exact forever — a counter must
        # never go backward no matter how many short-lived writer
        # threads come and go — while memory stays bounded by distinct
        # metric names (x reservoir for the retained recent samples).
        self._retired_counters: Dict[str, float] = {}
        self._retired_gauges: Dict[str, Tuple[int, float]] = {}
        self._retired_hist_totals: Dict[str, Tuple[int, float]] = {}
        self._retired_samples: Dict[str, deque] = {}
        # Global write sequence for gauge last-write-wins merging.
        # itertools.count.__next__ is GIL-atomic in CPython.
        self._seq = itertools.count()

    # -- recording -------------------------------------------------------

  
    def _fold_retired(self, shard: _Shard) -> None:
        """Fold a dead/displaced shard into the retired accumulators.
        Caller holds ``_shards_lock``."""
        for name, value in shard.counters.items():
            self._retired_counters[name] = (
                self._retired_counters.get(name, 0.0) + value
            )
        for name, seq_value in shard.gauges.items():
            prev = self._retired_gauges.get(name)
            if prev is None or seq_value[0] > prev[0]:
                self._retired_gauges[name] = seq_value
        for name, hist in shard.hists.items():
            count, total = self._retired_hist_totals.get(name, (0, 0.0))
            self._retired_hist_totals[name] = (
                count + hist.count, total + hist.sum
            )
            pool = self._retired_samples.get(name)
            if pool is None or pool.maxlen != self.reservoir:
                pool = deque(pool or (), maxlen=self.reservoir)
                self._retired_samples[name] = pool
            # Recent-window semantics: a short-lived thread's samples
            # (e.g. one checkpoint writer per write) stay visible to
            # percentiles through this bounded pool.
            pool.extend(hist.samples)

    def _shard(self) -> _Shard:
        prev = getattr(self._local, "shard", None)
        if prev is None or prev.reservoir != self.reservoir:
            shard = _Shard(self.reservoir)
            self._local.shard = shard
            ident = threading.get_ident()
            with self._shards_lock:
                old = self._shards.get(ident)
                if old is not None and old is not prev:
                    # Recycled ident: ``old`` belongs to a DEAD thread
                    # (idents are only reused after termination).
                    self._fold_retired(old)
                elif prev is not None:
                    # This thread's own resize.
                    self._fold_retired(prev)
                self._shards[ident] = shard
                # Periodic sweep at the (rare) registration seam: fold
                # shards whose threads are gone but whose idents were
                # never recycled, so _shards cannot grow one dead entry
                # per short-lived thread forever.
                live = {
                    t.ident for t in threading.enumerate()
                }
                for dead in [
                    i for i in self._shards if i not in live and i != ident
                ]:
                    self._fold_retired(self._shards.pop(dead))
            return shard
        return prev

    def counter(self, name: str) -> Counter:
        return Counter(self, name)

    def gauge(self, name: str) -> Gauge:
        return Gauge(self, name)

    def histogram(self, name: str) -> Histogram:
        return Histogram(self, name)

    def record_gauges(self, mapping: Dict[str, Any]) -> None:
        """Fold a flat ``{name: float}`` snapshot (the shape
        ``ServingMetrics``/``FleetMetrics`` already emit) into the
        registry as gauges — the bridge that merges the serving
        families into the one live namespace. Non-numeric values are
        skipped, same tolerance as the exposition renderer."""
        if not self.enabled:
            return
        shard = self._shard()
        for name, value in mapping.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            shard.gauges[name] = (next(self._seq), v)

    # -- reading ---------------------------------------------------------

    @staticmethod
    def _percentile(ordered: List[float], q: float) -> float:
        # Nearest-rank on the sorted window (ServingMetrics discipline):
        # cheap, monotone, exact at the tails.
        if not ordered:
            return 0.0
        idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
        return ordered[int(idx)]

    def snapshot(self) -> Dict[str, float]:
        """Merged flat view across every thread's shard: counters sum,
        gauges take the latest write, histograms flatten to
        ``{name}_p50/_p95/_p99/_count/_sum`` over the pooled recent
        samples (pooling raw samples, never averaging per-thread
        percentiles)."""
        with self._shards_lock:
            shards = list(self._shards.values())
            counters = dict(self._retired_counters)
            gauges = dict(self._retired_gauges)
            hists: Dict[str, Tuple[List[float], int, float]] = {
                name: (
                    list(self._retired_samples.get(name, ())),
                    count,
                    total,
                )
                for name, (count, total) in self._retired_hist_totals.items()
            }
        for shard in shards:
            # list()/dict() copies before iterating: the owning thread
            # may still be recording.
            for name, value in list(shard.counters.items()):
                counters[name] = counters.get(name, 0.0) + value
            for name, seq_value in list(shard.gauges.items()):
                prev = gauges.get(name)
                if prev is None or seq_value[0] > prev[0]:
                    gauges[name] = seq_value
            for name, hist in list(shard.hists.items()):
                samples, count, total = hists.get(name, ([], 0, 0.0))
                hists[name] = (
                    samples + list(hist.samples),
                    count + hist.count,
                    total + hist.sum,
                )
        out: Dict[str, float] = {}
        out.update(counters)
        for name, (_, value) in gauges.items():
            out[name] = value
        for name, (samples, count, total) in hists.items():
            ordered = sorted(samples)
            out[f"{name}_p50"] = self._percentile(ordered, 0.50)
            out[f"{name}_p95"] = self._percentile(ordered, 0.95)
            out[f"{name}_p99"] = self._percentile(ordered, 0.99)
            out[f"{name}_count"] = float(count)
            out[f"{name}_sum"] = total
        return out


# ----------------------------------------------------------------------
# Process-global registry
# ----------------------------------------------------------------------

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every instrumented seam resolves at
    call time."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous
    one."""
    global _default_registry
    previous = _default_registry
    _default_registry = registry
    return previous


def configure_metrics(
    enabled: Optional[bool] = None, reservoir: Optional[int] = None
) -> MetricsRegistry:
    """Re-shape the process-global registry in place (the entry points'
    ``telemetry`` / ``telemetry_reservoir`` knobs)."""
    registry = get_registry()
    if enabled is not None:
        registry.enabled = bool(enabled)
    if reservoir is not None:
        registry.reservoir = max(1, int(reservoir))
    return registry


# ----------------------------------------------------------------------
# TelemetryServer: GET /metrics for non-serving processes
# ----------------------------------------------------------------------


class TelemetryServer:
    """Stdlib HTTP endpoint over the registry, for processes that have
    no fleet frontend (a pipeline run, a bare ``train.py``):

    - ``GET /metrics`` — Prometheus text format 0.0.4 over the merged
      registry snapshot (the exporter the fleet already uses), i.e.
      everything a scraper/autoscaler needs from a training process.
    - ``GET /metrics.json`` — the same snapshot as flat JSON.

    ``extra_snapshot`` (zero-arg callable returning a flat dict) lets a
    caller merge live values computed outside the registry; it is
    re-read per request and failure-isolated — observability never
    takes down the process it observes.
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[MetricsRegistry] = None,
        namespace: str = "marl",
        extra_snapshot: Optional[Callable[[], Dict[str, float]]] = None,
    ) -> None:
        self._registry = registry
        self.namespace = namespace
        self.extra_snapshot = extra_snapshot
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._host = host
        self._port = int(port)

    def _snapshot(self) -> Dict[str, float]:
        snap = (self._registry or get_registry()).snapshot()
        # The program ledger's families (program{...} cost/memory/
        # dispatch gauges, device-memory watermark) ride the same
        # merged namespace. Lazy import: ledger.py imports this module
        # for its dispatch histograms.
        from marl_distributedformation_tpu_torch.obs.ledger import (
            merge_ledger_snapshot,
        )

        merge_ledger_snapshot(snap)
        if self.extra_snapshot is not None:
            try:
                snap.update(self.extra_snapshot())
            except Exception:  # noqa: BLE001 — a broken extra source
                pass  # must not break the scrape of the registry itself
        return snap

    def start(self) -> "TelemetryServer":
        if self._server is not None:
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args: Any) -> None:  # quiet server
                pass

            def do_GET(self) -> None:  # noqa: N802 — stdlib handler API
                from marl_distributedformation_tpu_torch.obs.export import (
                    PROMETHEUS_CONTENT_TYPE,
                    prometheus_exposition,
                )

                if self.path == "/metrics":
                    body = prometheus_exposition(
                        outer._snapshot(), namespace=outer.namespace
                    ).encode()
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif self.path == "/metrics.json":
                    body = json.dumps(outer._snapshot()).encode()
                    ctype = "application/json"
                else:
                    body = json.dumps(
                        {"error": f"unknown path {self.path}"}
                    ).encode()
                    self.send_response(404)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="telemetry-server",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}/metrics"

    def stop(self) -> None:
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
