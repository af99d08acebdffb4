"""metrics-in-traced-scope: metrics recording in a captured scope.

The MetricsRegistry (``obs/metrics.py``) is host-only by the same contract
as the tracer: counters, gauges and histograms are recorded at dispatch
seams (the trainer's drain, the scheduler's batch boundary, the gate's
verdict), never inside a body a ``PhaseGraph`` captures. A
``registry.counter(...).inc()`` there bumps at the warm-up and the
capture and never on a replay: it looks instrumented and measures
nothing.

Detection surfaces (how the registry is called):

- record calls whose receiver chain names the registry
  (``registry.gauge("x").set(v)``, ``get_registry().histogram(...)``)
  with the method in the recording set (``inc``/``set``/``observe``/
  ``record_gauges``) or the handle-minting set
  (``counter``/``gauge``/``histogram``);
- names imported from an ``obs``/``metrics`` module and called through;
- one same-module call hop, as the tracer's rule.

Receiver chains must look registry-like (``registry``/``get_registry``
in a part, or a root bound from the obs/metrics modules) before the
method-name check applies, so ``self._stop.set()`` and dict ``.update``
calls stay clean.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

# Recording entry points on a MetricsRegistry handle (obs/metrics.py).
_RECORD_METHODS = frozenset({"inc", "set", "observe", "record_gauges"})
# Handle minting on the registry itself — host dict/shard work too.
_HANDLE_METHODS = frozenset({"counter", "gauge", "histogram"})
# Module-path fragments that mark an import as the metrics plane.
_METRICS_MODULE_PARTS = frozenset({"obs", "metrics"})


def _is_metrics_module(module: str) -> bool:
    return any(part in _METRICS_MODULE_PARTS for part in module.split("."))


class MetricsInTracedScope(Rule):
    name = "metrics-in-traced-scope"
    default_severity = "error"
    description = (
        "obs.MetricsRegistry counter/gauge/histogram recording reachable "
        "inside a captured scope (a PhaseGraph's fn) — it records at the "
        "warm-up and the capture, never on replay; record at the "
        "dispatch seam instead"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        metrics_names = self._metrics_imports(ctx.tree)
        reported: Set[Tuple[int, int]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_traced_scope(node) is None:
                continue
            hit = self._record_call(ctx, node, metrics_names)
            if hit and (node.lineno, node.col_offset) not in reported:
                reported.add((node.lineno, node.col_offset))
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{hit} inside a captured scope records at the warm-up and "
                    "the capture only (never per replay) — metrics are "
                    "host-side only; record at the dispatch seam around "
                    "the PhaseGraph call",
                )

    # -- import surface ---------------------------------------------------

    @staticmethod
    def _metrics_imports(tree: ast.Module) -> Set[str]:
        """Local names bound from obs/metrics modules: both
        ``from ...obs.metrics import get_registry`` targets and
        ``import ...obs.metrics as m`` aliases."""
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if _is_metrics_module(node.module or ""):
                    for alias in node.names:
                        if alias.name != "*":
                            names.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_metrics_module(alias.name):
                        names.add(alias.asname or alias.name.split(".")[0])
        return names

    # -- call classification ----------------------------------------------

    def _record_call(
        self, ctx: ModuleContext, node: ast.Call, metrics_names: Set[str]
    ) -> Optional[str]:
        """A human-readable description when this call records to the
        metrics plane (directly or one same-module hop away); else
        None."""
        direct = self._direct_record(node, metrics_names)
        if direct:
            return direct
        # One call hop: a captured scope calling a same-module helper that
        # records.
        if isinstance(node.func, ast.Name):
            for definition in ctx._defs_by_name.get(node.func.id, ()):
                for inner in ast.walk(definition):
                    if isinstance(inner, ast.Call):
                        hit = self._direct_record(inner, metrics_names)
                        if hit:
                            return f"{node.func.id}() reaches {hit}"
        return None

    def _direct_record(
        self, node: ast.Call, metrics_names: Set[str]
    ) -> Optional[str]:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return None
        if (
            func.attr not in _RECORD_METHODS
            and func.attr not in _HANDLE_METHODS
        ):
            return None
        if self._registry_like(func.value, metrics_names):
            rname = dotted_name(func.value)
            if rname is None and isinstance(func.value, ast.Call):
                inner = dotted_name(func.value.func)
                rname = f"{inner}()" if inner else "<registry>()"
            return f"{rname or '<registry>'}.{func.attr}(...)"
        return None

    def _registry_like(
        self, expr: ast.AST, metrics_names: Set[str]
    ) -> bool:
        """Does this receiver expression denote the metrics registry (or
        a handle freshly minted from one)?"""
        if isinstance(expr, ast.Call):
            fname = dotted_name(expr.func) or ""
            if fname:
                parts = fname.split(".")
                # get_registry() / obs.get_registry() / m.get_registry()
                if parts[-1] == "get_registry" or parts[0] in metrics_names:
                    return True
            # registry.counter("x") as a receiver: peel the handle mint.
            if isinstance(expr.func, ast.Attribute) and (
                expr.func.attr in _HANDLE_METHODS
            ):
                return self._registry_like(expr.func.value, metrics_names)
            return False
        rname = dotted_name(expr)
        if rname is None:
            return False
        parts = rname.split(".")
        return (
            any("registry" in p.lower() for p in parts)
            or parts[0] in metrics_names
        )
