"""Fleet observability: the aggregate view a multi-replica server needs.

Counterpart of the JAX package's ``serving/fleet/metrics.py``, the same
code over the port's schedulers and engines.

Per-replica ``ServingMetrics`` already exist (each scheduler owns one);
what the fleet layer adds is the numbers that only make sense ABOVE the
replicas:

- ``fleet_routed_total`` / per-replica routed counts — routing skew is
  the router's core behavior; a flat-lined replica under load means the
  drain estimator or the health state is wrong.
- ``fleet_failed_over_total`` — requests transparently re-routed off a
  dying replica. Nonzero during an incident is the system WORKING;
  nonzero in steady state means a replica is flapping.
- ``fleet_rejected_total`` — fleet-level backpressure: every healthy
  replica was full. This is the number capacity planning watches.
- ``fleet_breaks_total`` / ``fleet_healthy_replicas`` — circuit-breaker
  activity and the live serving width.
- merged ``latency_p50/p95/p99_ms`` — computed over the raw latency
  samples of every replica pooled together (averaging per-replica
  percentiles is statistically meaningless).

``snapshot(replicas)`` returns the flat ``{name: float}`` dict shape the
rest of the repo logs through ``utils.logging.MetricsLogger``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

from marl_distributedformation_tpu_torch.obs.metrics import get_registry
from marl_distributedformation_tpu_torch.serving.metrics import ServingMetrics


class FleetMetrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.routed_total = 0  # graftlock: guarded-by=_lock
        self.rejected_total = 0  # graftlock: guarded-by=_lock
        self.failed_over_total = 0  # graftlock: guarded-by=_lock
        self.breaks_total = 0  # graftlock: guarded-by=_lock
        self.probes_total = 0  # graftlock: guarded-by=_lock
        self._routed_per_replica: Dict[int, int] = {}  # graftlock: guarded-by=_lock

    # -- recording (router side) ----------------------------------------

    def record_routed(self, replica: int) -> int:
        """Returns the new fleet-wide routed count (the router uses it
        to pace logger emission)."""
        with self._lock:
            self.routed_total += 1
            self._routed_per_replica[replica] = (
                self._routed_per_replica.get(replica, 0) + 1
            )
            return self.routed_total

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected_total += 1

    def record_failover(self) -> None:
        with self._lock:
            self.failed_over_total += 1

    def record_break(self) -> None:
        with self._lock:
            self.breaks_total += 1

    def record_probe(self) -> None:
        with self._lock:
            self.probes_total += 1

    # -- reading ---------------------------------------------------------

    def routed_per_replica(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._routed_per_replica)

    def snapshot(self, replicas: Sequence) -> Dict[str, float]:
        """Flat float dict over the fleet counters plus every replica's
        own metrics; ``replicas`` is the router's replica list (each
        exposes ``.index``, ``.healthy``, ``.scheduler.metrics``)."""
        with self._lock:
            out: Dict[str, float] = {
                "fleet_replicas": float(len(replicas)),
                "fleet_routed_total": float(self.routed_total),
                "fleet_rejected_total": float(self.rejected_total),
                "fleet_failed_over_total": float(self.failed_over_total),
                "fleet_breaks_total": float(self.breaks_total),
                "fleet_probes_total": float(self.probes_total),
            }
            routed = dict(self._routed_per_replica)
        merged: List[float] = []
        healthy = 0
        # Per-rung shard/dtype gauges: one entry per (rung, dtype) the
        # fleet's engines serve — "is this rung mesh-sharded", "what has
        # it compiled" — folded into labeled Prometheus families by
        # obs/export.py (``rung_sharded{rung=...,dtype=...}``), so the
        # tracing spine sees the sharded/bf16 engines through the
        # existing ``GET /v1/metrics`` endpoint.
        rungs: Dict[str, float] = {}
        drain_s = 0.0
        for r in replicas:
            m = r.scheduler.metrics
            snap = m.snapshot()
            healthy += int(r.healthy)
            merged.extend(m.latencies_snapshot())
            # Host-level backlog estimate: the sum of every replica's
            # drain time. Rides the mesh heartbeat as the gossip field
            # the MetaRouter routes on (serving/mesh/router.py) — the
            # same join-the-shortest-TIME-queue quantity the fleet
            # router uses per replica, aggregated per host.
            drain_s += float(r.scheduler.estimated_drain_s())
            out[f"replica{r.index}_routed"] = float(routed.get(r.index, 0))
            out[f"replica{r.index}_requests"] = snap["requests"]
            out[f"replica{r.index}_occupancy_pct"] = snap[
                "batch_occupancy_pct"
            ]
            out[f"replica{r.index}_queue_depth"] = snap["queue_depth"]
            out[f"replica{r.index}_healthy"] = float(r.healthy)
            out[f"replica{r.index}_batch_preempted_total"] = snap[
                "batch_preempted_total"
            ]
            engine = getattr(r, "engine", None)
            if engine is not None:
                dtype = getattr(engine, "dtype_label", "f32")
                is_sharded = bool(getattr(engine, "is_sharded", False))
                kind = "sharded" if is_sharded else "replicated"
                for bucket, count in engine.compile_counts().items():
                    prefix = f"rung{bucket}_{dtype}"
                    # "a mesh slice serves this (rung, dtype)" — kept
                    # per (rung, dtype) deliberately; WHICH engine kind
                    # compiled what is the kind-labeled gauge below
                    # (both kinds can serve the same rung, so folding
                    # compile counts across kinds would make a receipt
                    # breach unattributable).
                    rungs[f"{prefix}_sharded"] = max(
                        rungs.get(f"{prefix}_sharded", 0.0),
                        float(is_sharded),
                    )
                    ckey = f"{prefix}_{kind}_compiles"
                    rungs[ckey] = max(rungs.get(ckey, 0.0), float(count))
        out.update(rungs)
        out["fleet_healthy_replicas"] = float(healthy)
        out["fleet_estimated_drain_s"] = drain_s
        ordered = sorted(merged)
        pct = ServingMetrics._percentile
        out["latency_p50_ms"] = 1e3 * pct(ordered, 0.50)
        out["latency_p95_ms"] = 1e3 * pct(ordered, 0.95)
        out["latency_p99_ms"] = 1e3 * pct(ordered, 0.99)
        # Registry-backed emission (obs/metrics.py): every snapshot also
        # lands in the process-global registry, so the serving families
        # and the trainer/pipeline gauges render as ONE merged Prometheus
        # namespace (fleet ``GET /v1/metrics`` text view, the
        # TelemetryServer's ``GET /metrics``, and the RollbackMonitor's
        # sampling path all read the same numbers).
        get_registry().record_gauges(out)
        return out
