"""span-in-traced-scope: tracer spans and events in a captured scope.

The tracing spine (``obs/tracer.py``) is host-only by contract: spans and
events are recorded at dispatch seams, around a ``PhaseGraph`` call, never
inside the body it captures. A ``tracer.span(...)`` / ``event(...)`` /
``incident(...)`` reachable in a captured scope runs on the eager warm-up
call and during the capture, and never on a replay: the ring shows two
records for a phase that ran a thousand times, and ``incident``'s file IO
sits in the capture.

Detection surfaces (how the spine is called):

- method calls whose receiver chain names a tracer (``tracer.span``,
  ``self._tracer.event``, ``obs.get_tracer().incident``) with the method in
  the recording set;
- names imported from an ``obs``/``tracer`` module and called directly;
- one same-module call hop: a captured scope calling a local helper that
  records. Functions reached across modules are captured scopes of their
  own module (``analysis/callgraph.py``).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

# Recording entry points on a Tracer (obs/tracer.py). incident() dumps
# the flight recorder — file IO in a capture is the worst of the bunch.
_RECORD_METHODS = frozenset({"span", "event", "add_span", "incident"})
# Module-path fragments that mark an import as the tracing spine.
_OBS_MODULE_PARTS = frozenset({"obs", "tracer"})


def _is_obs_module(module: str) -> bool:
    return any(part in _OBS_MODULE_PARTS for part in module.split("."))


class SpanInTracedScope(Rule):
    name = "span-in-traced-scope"
    default_severity = "error"
    description = (
        "obs.Tracer span/event recording reachable inside a captured "
        "scope (a PhaseGraph's fn) — it runs at the warm-up and the "
        "capture, never on replay; record at the dispatch seam instead"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        obs_names = self._obs_imports(ctx.tree)
        reported: Set[Tuple[int, int]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_traced_scope(node) is None:
                continue
            hit = self._record_call(ctx, node, obs_names)
            if hit and (node.lineno, node.col_offset) not in reported:
                reported.add((node.lineno, node.col_offset))
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{hit} inside a captured scope records at the warm-up and "
                    "the capture only, never on a replay — tracing is "
                    "host-side only; move the span to the dispatch seam "
                    "around the PhaseGraph call",
                )

    # -- import surface ---------------------------------------------------

    @staticmethod
    def _obs_imports(tree: ast.Module) -> Set[str]:
        """Local names bound from obs/tracer modules: both
        ``from ...obs import get_tracer`` targets and ``import ...obs
        as o`` aliases."""
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if _is_obs_module(node.module or ""):
                    for alias in node.names:
                        if alias.name != "*":
                            names.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_obs_module(alias.name):
                        names.add(alias.asname or alias.name.split(".")[0])
        return names

    # -- call classification ----------------------------------------------

    def _record_call(
        self, ctx: ModuleContext, node: ast.Call, obs_names: Set[str]
    ) -> Optional[str]:
        """A human-readable description when this call records to the
        tracing spine (directly or one same-module hop away); else None."""
        direct = self._direct_record(node, obs_names)
        if direct:
            return direct
        # One call hop: a captured scope calling a same-module helper that
        # records.
        if isinstance(node.func, ast.Name):
            for definition in ctx._defs_by_name.get(node.func.id, ()):
                for inner in ast.walk(definition):
                    if isinstance(inner, ast.Call):
                        hit = self._direct_record(inner, obs_names)
                        if hit:
                            return (
                                f"{node.func.id}() reaches {hit}"
                            )
        return None

    def _direct_record(
        self, node: ast.Call, obs_names: Set[str]
    ) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr not in _RECORD_METHODS:
                return None
            receiver = func.value
            # get_tracer().span(...) / obs.get_tracer().event(...)
            if isinstance(receiver, ast.Call):
                rname = dotted_name(receiver.func) or ""
                if rname.split(".")[-1] == "get_tracer" or (
                    rname.split(".")[0] in obs_names
                ):
                    return f"{rname}().{func.attr}(...)"
                return None
            rname = dotted_name(receiver)
            if rname is None:
                return None
            parts = rname.split(".")
            if any("tracer" in p.lower() for p in parts) or (
                parts[0] in obs_names
            ):
                return f"{rname}.{func.attr}(...)"
            return None
        if isinstance(func, ast.Name):
            if func.id in obs_names and func.id in _RECORD_METHODS:
                return f"{func.id}(...)"
        return None
