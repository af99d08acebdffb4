"""The tracing spine: trace-ID propagation, spans, flight recorder.

Counterpart of the JAX package's ``obs/`` tracer and flight recorder:

- :class:`~.tracer.Tracer` — lock-cheap per-thread ring buffers of
  spans/events on a monotonic clock, with a process-global registry
  (:func:`get_tracer` / :func:`configure`). Recording sits strictly on
  host-side seams, never inside a captured CUDA graph.
- :class:`~.flightrec.FlightRecorder` — incident-triggered last-N
  snapshots (scheduler worker death, ...) to ``flightrec-*.json``.

The metrics registry, the program ledger, the regression sentinel and the
exporters are not ported yet (ROADMAP A13). Imports nothing but the
standard library.
"""

from marl_distributedformation_tpu_torch.obs.flightrec import FlightRecorder
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
    "Span",
    "TRACE_HEADER",
    "Tracer",
    "configure",
    "get_tracer",
    "new_trace_id",
    "sanitize_trace_id",
    "set_tracer",
]
