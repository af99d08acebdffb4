"""Exporters: Chrome trace-event JSON and Prometheus text exposition.

Counterpart of the JAX package's ``obs/export.py``: the same text, byte for
byte, for the same snapshot.

Two read-side formats over the same data:

- :func:`chrome_trace` turns a tracer snapshot (``Tracer.snapshot()`` /
  a ``Tracer.dump`` file's ``records``) into the Chrome trace-event
  format Perfetto and ``chrome://tracing`` load — one lane (tid) per
  recording thread, complete-events (``ph: "X"``) for spans, instants
  (``ph: "i"``) for events, trace IDs and attrs in ``args``. Timestamps
  are epoch microseconds, so a file produced here merges cleanly
  alongside ``TraceWindow``'s ``torch.profiler`` captures in the same
  viewer session.
- :func:`prometheus_exposition` renders any flat ``{name: float}``
  snapshot (the shape every metrics object in this repo already emits)
  as Prometheus text format 0.0.4: ``# TYPE`` lines, ``_total`` keys as
  counters, everything else as gauges, ``replica{i}_*`` keys folded into
  one metric with a ``replica`` label, label values escaped per the
  exposition spec. ``metrics.TelemetryServer`` serves it from
  ``GET /metrics``; :func:`wants_prometheus` is the content negotiation
  an endpoint that defaults to JSON uses.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Tuple

# ----------------------------------------------------------------------
# Chrome trace events
# ----------------------------------------------------------------------


def chrome_trace(
    records: Iterable[dict], process_name: str = "marl-obs"
) -> dict:
    """Chrome trace-event JSON (object form) from tracer snapshot
    records. Unknown/malformed records are skipped, not fatal — a
    partially-scrolled ring must still render."""
    lanes: Dict[str, int] = {}
    events: List[dict] = []

    def lane(thread: str) -> int:
        if thread not in lanes:
            lanes[thread] = len(lanes) + 1
        return lanes[thread]

    for rec in records:
        try:
            name = str(rec["name"])
            tid = lane(str(rec.get("thread", "main")))
            ts = float(rec["t0"]) * 1e6
            args = dict(rec.get("attrs") or {})
            if rec.get("trace_id"):
                args["trace_id"] = rec["trace_id"]
            if rec.get("kind") == "span":
                dur = max(0.0, float(rec["t1"]) - float(rec["t0"])) * 1e6
                events.append(
                    {
                        "name": name,
                        "ph": "X",
                        "ts": ts,
                        "dur": dur,
                        "pid": 1,
                        "tid": tid,
                        "args": args,
                    }
                )
            else:
                events.append(
                    {
                        "name": name,
                        "ph": "i",
                        "s": "t",
                        "ts": ts,
                        "pid": 1,
                        "tid": tid,
                        "args": args,
                    }
                )
        except (KeyError, TypeError, ValueError):
            continue
    meta: List[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": process_name},
        }
    ]
    for thread, tid in lanes.items():
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": thread},
            }
        )
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


# ----------------------------------------------------------------------
# Prometheus text exposition (format 0.0.4)
# ----------------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_REPLICA_KEY = re.compile(r"^replica(\d+)_(.+)$")
# Tenant-lane keys (serving/tenancy): ``model_{id}__{metric}`` folds
# into a ``model_{metric}`` family with a ``model`` label — per-tenant
# series are one label dimension on one family, not a key explosion
# per lane (the PR-9 label-folding discipline). The delimiter is the
# FIRST double underscore: lane names forbid ``__``
# (tenancy/directory.py), so the split is unambiguous whatever the
# metric remainder contains.
_MODEL_KEY = re.compile(r"^model_(.+?)__(.+)$")
# Per-rung serving gauges (fleet/metrics.py): rung size + inference
# dtype (+ engine kind, where the key carries one — both kinds can
# serve the same rung, so e.g. compile receipts need the attribution)
# become labels, so "which rungs are sharded / bf16 / compiled" is one
# queryable family, not a key explosion. Kind-keyed first: the plain
# pattern would swallow "sharded_compiles" as the metric name.
_RUNG_KIND_KEY = re.compile(
    r"^rung(\d+)_(f32|bf16)_(replicated|sharded)_(.+)$"
)
_RUNG_KEY = re.compile(r"^rung(\d+)_(f32|bf16)_(.+)$")
# Percentile triples — the registry's histogram snapshot keys
# (``{name}_p50``) and the serving metrics' latency keys
# (``latency_p50_ms``) — fold into ONE ``summary``-typed family with a
# ``quantile`` label instead of three ad-hoc gauge names (the same
# naming discipline the rung gauges got in PR 9).
_QUANTILE_KEY = re.compile(r"^(.+)_p(50|95|99)(_(?:ms|us|s))?$")
_QUANTILES = {"50": "0.5", "95": "0.95", "99": "0.99"}
# Program-ledger keys (obs/ledger.py): ``program_{key}_{field}`` folds
# into a ``program_{field}`` family with a ``program`` label — one
# queryable family per cost/memory/timing fact across every compiled
# executable, instead of a key explosion per program. The field
# alternation is the ledger's closed suffix set, so the split is
# unambiguous whatever the program key contains.
_PROGRAM_KEY = re.compile(
    r"^program_(.+)_("
    r"flops|bytes_accessed|argument_bytes|output_bytes|temp_bytes|"
    r"alias_bytes|generated_code_bytes|trace_seconds|lower_seconds|"
    r"compile_seconds|first_dispatch_seconds|traces_total|"
    r"dispatches_total|dispatch_seconds_(?:p(?:50|95|99)|count|sum)"
    r")$"
)
_PROGRAM_QUANTILE = re.compile(r"^dispatch_seconds_p(50|95|99)$")
_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(key: str, namespace: str) -> str:
    name = _NAME_OK.sub("_", f"{namespace}_{key}" if namespace else key)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote, and newline."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _render_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def prometheus_exposition(
    snapshot: Dict[str, float],
    namespace: str = "marl",
    labels: Optional[Dict[str, str]] = None,
) -> str:
    """Render a flat float snapshot as Prometheus text format.

    ``replica{i}_{metric}`` keys fold into one ``{metric}`` family with
    a ``replica="i"`` label (per-replica series belong under one metric
    name, not N names); ``model_{id}__{metric}`` keys (tenant lanes,
    serving/tenancy) fold into a ``model_{metric}`` family with a
    ``model`` label; ``rung{B}_{dtype}_{metric}`` keys fold into a
    ``rung_{metric}`` family with ``rung``/``dtype`` labels (the
    serving ladder's shard/bf16 gauges); ``{metric}_p50/_p95/_p99``
    percentile triples (registry histograms, serving latency keys) fold
    into one ``summary``-typed ``{metric}`` family with ``quantile``
    labels. ``*_total`` keys are typed ``counter``, the rest ``gauge``.
    Non-numeric values are skipped — a snapshot is allowed to carry
    annotations without breaking the scrape."""
    base_labels = [
        (k, str(v)) for k, v in sorted((labels or {}).items())
    ]
    # metric name -> (type, [(label pairs, value), ...]) preserving the
    # first-seen order of families.
    families: Dict[str, Tuple[str, List[Tuple[List[Tuple[str, str]], float]]]] = {}
    for key, value in snapshot.items():
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue
        m = _REPLICA_KEY.match(key)
        model = _MODEL_KEY.match(key)
        rung_kind = _RUNG_KIND_KEY.match(key)
        rung = _RUNG_KEY.match(key)
        quantile = _QUANTILE_KEY.match(key)
        program = _PROGRAM_KEY.match(key)
        if program:
            field = program.group(2)
            extra = [("program", program.group(1))]
            pq = _PROGRAM_QUANTILE.match(field)
            if pq:
                metric = "program_dispatch_seconds"
                extra.append(("quantile", _QUANTILES[pq.group(1)]))
                quantile = pq  # summary-typed family
            else:
                metric = f"program_{field}"
                quantile = None
        elif model:
            rest = model.group(2)
            extra = [("model", model.group(1))]
            mq = _QUANTILE_KEY.match(rest)
            if mq:
                # A per-lane percentile triple composes both folds:
                # one summary family, model AND quantile labels.
                metric = "model_" + mq.group(1) + (mq.group(3) or "")
                extra.append(("quantile", _QUANTILES[mq.group(2)]))
                quantile = mq
            else:
                metric = f"model_{rest}"
                quantile = None
        elif m:
            metric, extra = m.group(2), [("replica", m.group(1))]
        elif rung_kind:
            metric = f"rung_{rung_kind.group(4)}"
            extra = [
                ("dtype", rung_kind.group(2)),
                ("kind", rung_kind.group(3)),
                ("rung", rung_kind.group(1)),
            ]
        elif rung:
            metric = f"rung_{rung.group(3)}"
            extra = [("dtype", rung.group(2)), ("rung", rung.group(1))]
        elif quantile:
            metric = quantile.group(1) + (quantile.group(3) or "")
            extra = [("quantile", _QUANTILES[quantile.group(2)])]
        else:
            metric, extra = key, []
        name = _metric_name(metric, namespace)
        if quantile and not (m or rung_kind or rung):
            kind = "summary"
        elif metric.endswith("_total"):
            kind = "counter"
        else:
            kind = "gauge"
        fam = families.setdefault(name, (kind, []))
        fam[1].append((base_labels + extra, v))
    lines: List[str] = []
    for name, (kind, series) in families.items():
        lines.append(f"# TYPE {name} {kind}")
        for pairs, v in series:
            if pairs:
                rendered = ",".join(
                    f'{k}="{escape_label_value(v_)}"' for k, v_ in pairs
                )
                lines.append(f"{name}{{{rendered}}} {_render_value(v)}")
            else:
                lines.append(f"{name} {_render_value(v)}")
    return "\n".join(lines) + "\n"


def wants_prometheus(accept_header: Optional[str]) -> bool:
    """Content negotiation for ``GET /v1/metrics``: Prometheus text only
    when the client PREFERS it (``text/plain`` or an openmetrics type
    outranking ``application/json`` by q-value in ``Accept``);
    bare/absent/wildcard Accept keeps the JSON default, so every
    existing client is untouched. Media ranges are parsed, not
    substring-matched — a JSON client sending a compound header like
    ``application/json, text/plain, */*`` (axios's default) still gets
    JSON; ties go to the JSON default."""
    if not accept_header:
        return False
    prom_q = 0.0
    json_q = 0.0
    for media_range in accept_header.lower().split(","):
        parts = media_range.split(";")
        mtype = parts[0].strip()
        q = 1.0
        for param in parts[1:]:
            k, _, v = param.partition("=")
            if k.strip() == "q":
                try:
                    q = float(v.strip())
                except ValueError:
                    q = 0.0
        if mtype in ("text/plain", "application/openmetrics-text"):
            prom_q = max(prom_q, q)
        elif mtype == "application/json":
            json_q = max(json_q, q)
    return prom_q > 0.0 and prom_q > json_q
