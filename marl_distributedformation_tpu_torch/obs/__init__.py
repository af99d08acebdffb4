"""The observability plane: tracing spine, metrics, program ledger, export.

Counterpart of the JAX package's ``obs/``:

- :class:`~.tracer.Tracer` — lock-cheap per-thread ring buffers of
  spans/events on a monotonic clock, with a process-global registry
  (:func:`get_tracer` / :func:`configure`). Recording sits strictly on
  host-side seams, never inside a captured CUDA graph.
- :class:`~.flightrec.FlightRecorder` — incident-triggered last-N
  snapshots (scheduler worker death, ...) to ``flightrec-*.json``.
- :class:`~.metrics.MetricsRegistry` — process-global counters, gauges
  and bounded-reservoir histograms on per-thread shards, served as
  Prometheus text by :class:`~.metrics.TelemetryServer` (``GET
  /metrics``).
- :class:`~.ledger.ProgramLedger` — every built program (a captured CUDA
  graph, an eager build on the CPU) with its build timings, graph nodes,
  cost facts, dispatch latencies and the device-memory watermark; the
  census is ``logs/{name}/program_ledger.json`` in the JAX package's
  schema.
- :mod:`~.export` — Chrome trace-event JSON and Prometheus text
  exposition, byte-equal to the JAX package's for the same snapshot.
- :class:`~.sentinel.RegressionSentinel` — compares live registry gauges
  against a bench record of this device with a tolerance band and trip
  hysteresis; sustained degradation dumps a
  ``flightrec-perf_regression-*.json`` and an audit line. A record of
  another device (a TPU's, a CPU's on the card) is not used.

Imports nothing but the standard library.
"""

from marl_distributedformation_tpu_torch.obs.export import (
    PROMETHEUS_CONTENT_TYPE,
    chrome_trace,
    escape_label_value,
    prometheus_exposition,
    wants_prometheus,
)
from marl_distributedformation_tpu_torch.obs.flightrec import FlightRecorder
from marl_distributedformation_tpu_torch.obs.ledger import (
    ProgramLedger,
    ProgramRecord,
    configure_ledger,
    get_ledger,
    load_census,
    merge_ledger_snapshot,
    set_ledger,
)
from marl_distributedformation_tpu_torch.obs.metrics import (
    MetricsRegistry,
    TelemetryServer,
    configure_metrics,
    get_registry,
    set_registry,
)
from marl_distributedformation_tpu_torch.obs.sentinel import (
    RegressionSentinel,
    Watch,
    default_watches,
    ledger_watches,
    load_bench_record,
    recovery_watches,
)
from marl_distributedformation_tpu_torch.obs.tracer import (
    TRACE_HEADER,
    Event,
    Span,
    Tracer,
    configure,
    get_tracer,
    new_trace_id,
    sanitize_trace_id,
    set_tracer,
)

__all__ = [
    "Event",
    "FlightRecorder",
    "MetricsRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "ProgramLedger",
    "ProgramRecord",
    "RegressionSentinel",
    "Span",
    "TRACE_HEADER",
    "TelemetryServer",
    "Tracer",
    "Watch",
    "chrome_trace",
    "configure",
    "configure_ledger",
    "configure_metrics",
    "default_watches",
    "escape_label_value",
    "get_ledger",
    "get_registry",
    "get_tracer",
    "ledger_watches",
    "load_bench_record",
    "load_census",
    "merge_ledger_snapshot",
    "new_trace_id",
    "prometheus_exposition",
    "recovery_watches",
    "sanitize_trace_id",
    "set_ledger",
    "set_registry",
    "set_tracer",
    "wants_prometheus",
]
