"""host-nonfinite-probe-in-dispatch-loop: a host finiteness probe per
iteration of a dispatch loop.

The opposite polarity of its siblings: a **host-side** probe inside a
``while``/``for`` loop outside any captured scope —
``torch.isnan(x).any()`` / ``torch.isinf`` / ``torch.isfinite`` (or
``x.isnan()``), consumed by the host, or a ``math``/``np`` finiteness
check wrapped around a ``float(...)``/``.item()`` pull
(``math.isnan(float(loss))``). Each probe blocks the host on the device
once an iteration, and under fused dispatch it is K iterations too late
anyway. The in-graph health word replaces it (``train/recovery.py``):
finiteness is computed on the device, rides the chunk's metrics through
the one drain the loop already pays, and the select skip-guard contains
the poisoned iteration with no host round trip.

Detection:

- a torch finiteness call whose result the host consumes in the loop
  body: under ``.any()``/``.all()``/``.item()``/``bool()``, or as the
  test of an ``if``/``while``;
- ``math``/``np`` finiteness over a ``float()``/``.item()`` pull;
- a plain-name call into a helper chain that probes, followed on the
  call graph (``analysis/callgraph.py``) to its depth bound; helpers that
  are captured scopes are pruned (their probe is the health word).

Clean, deliberately: ``np.isfinite`` over already-drained numpy arrays,
``float(v)`` on drained metrics, a probe whose result stays on the device,
and any probe outside a loop (the trainer's one-shot end-of-run check).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis import callgraph
from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

_PROBE_ATTRS = frozenset({"isnan", "isinf", "isfinite"})
_HOST_ROOTS = frozenset({"math", "np", "numpy"})
# What pulls a device value into the host.
_CONSUMERS = frozenset({"any", "all", "item"})


def _torch_probe(node: ast.Call) -> bool:
    """``torch.isnan(x)`` or ``x.isnan()``."""
    fname = dotted_name(node.func) or ""
    if fname.startswith("torch.") and fname.rsplit(".", 1)[-1] in (
            _PROBE_ATTRS):
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _PROBE_ATTRS
            and dotted_name(node.func.value) not in _HOST_ROOTS
            and not fname.startswith(("math.", "np.", "numpy.")))


def _host_probe_name(fname: Optional[str]) -> bool:
    if not fname or "." not in fname:
        return False
    root, attr = fname.rsplit(".", 1)
    return attr in _PROBE_ATTRS and root in _HOST_ROOTS


def _has_float_extraction(node: ast.Call) -> bool:
    """Does any argument contain a ``float(...)``/``.item()`` pull?"""
    for arg in ast.walk(node):
        if isinstance(arg, ast.Call):
            if isinstance(arg.func, ast.Name) and arg.func.id == "float":
                return True
            if (
                isinstance(arg.func, ast.Attribute)
                and arg.func.attr == "item"
            ):
                return True
    return False


def _consumed_probe(node: ast.AST) -> Optional[str]:
    """The torch probe the host consumes at ``node`` (a ``.any()`` /
    ``.all()`` / ``.item()`` / ``bool()`` over one), if any."""
    if not isinstance(node, ast.Call):
        return None
    inner: Optional[ast.AST] = None
    if isinstance(node.func, ast.Attribute) and node.func.attr in _CONSUMERS:
        inner = node.func.value
    elif (isinstance(node.func, ast.Name) and node.func.id == "bool"
          and node.args):
        inner = node.args[0]
    if inner is None:
        return None
    for sub in ast.walk(inner):
        if isinstance(sub, ast.Call) and _torch_probe(sub):
            return f"{ast.unparse(sub.func)}(...)"
    return None


def _probe_pred(node: ast.Call, fname) -> "str | None":
    """Call-graph predicate: is this call site a host finiteness probe?"""
    hit = _consumed_probe(node)
    if hit:
        return hit
    if _host_probe_name(fname) and _has_float_extraction(node):
        return f"{fname}(float(...))"
    return None


class HostNonfiniteProbeInDispatchLoop(Rule):
    name = "host-nonfinite-probe-in-dispatch-loop"
    default_severity = "error"
    description = (
        "a host-consumed torch.isnan/isinf/isfinite (or a math/np probe "
        "over a float() pull) inside a while/for dispatch loop — one "
        "device sync per iteration, and K iterations too late under fused "
        "dispatch; compute the health word in the graph instead "
        "(train/recovery.py)"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        reported: Set[Tuple[int, int]] = set()
        for loop in self._host_loops(ctx):
            for hit in self._scan_body(ctx, loop):
                if hit[:2] not in reported:
                    reported.add(hit[:2])
                    yield hit

    @staticmethod
    def _host_loops(ctx: ModuleContext) -> List[ast.AST]:
        """Every while/for loop outside captured scopes."""
        return [
            node
            for node in ast.walk(ctx.tree)
            if isinstance(node, (ast.While, ast.For))
            and not ctx._has_traced_ancestor(node)
        ]

    def _scan_body(
        self, ctx: ModuleContext, loop: ast.AST
    ) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(loop):
            hit = None
            if isinstance(node, (ast.If, ast.While)) and node is not loop:
                test = node.test
                if isinstance(test, ast.Call) and _torch_probe(test):
                    hit = (test, f"{ast.unparse(test.func)}(...)")
            elif (isinstance(node, ast.Call)
                  and ctx.enclosing_traced_scope(node) is None):
                matched = self._probe_call(ctx, node)
                if matched:
                    hit = (node, matched)
            if hit is None:
                continue
            where, what = hit
            yield (
                where.lineno,
                where.col_offset,
                f"{what} inside a dispatch loop forces one device sync "
                "per iteration (and sees fused divergence K iterations "
                "late) — compute the health word in the graph and consume "
                "it at the chunk drain (train/recovery.py)",
            )

    def _probe_call(self, ctx: ModuleContext,
                    node: ast.Call) -> Optional[str]:
        fname = dotted_name(node.func)
        direct = _probe_pred(node, fname)
        if direct:
            return direct
        # Helper chains on the call graph; captured callees are pruned —
        # their probes are the health word, the fix and not the hazard.
        if isinstance(node.func, ast.Name):
            hit = callgraph.reachable_call(
                ctx,
                node,
                _probe_pred,
                first_hops=frozenset({"local", "import"}),
                prune=lambda f: callgraph.traced_in_own_module(f, ctx),
            )
            if hit is not None:
                return f"{node.func.id}() reaches {hit.matched}"
        return None
