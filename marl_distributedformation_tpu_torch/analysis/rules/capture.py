"""mutable-capture-in-jit: host state mutated in a captured scope.

A mutable default argument (``def step(x, buf=[])``) or a ``global`` /
``nonlocal`` write inside a body a ``PhaseGraph`` captures executes at the
warm-up and the capture, not on a replay: the side effect happens twice
and never per step, the classic "my counter only advanced twice" bug.
Reads of module globals (constants, config) stay allowed.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
_MUTABLE_CTORS = frozenset(
    {"list", "dict", "set", "bytearray", "collections.deque", "deque"})


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, _MUTABLE_LITERALS):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in _MUTABLE_CTORS
    return False


class MutableCaptureInJit(Rule):
    name = "mutable-capture-in-jit"
    default_severity = "error"
    description = (
        "mutable default argument or global/nonlocal write in a captured "
        "scope (a PhaseGraph's fn) — the side effect runs at the warm-up "
        "and the capture, not per replay"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for root in ctx.traced_roots:
            for node in ast.walk(root):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defaults = [
                        *node.args.defaults, *node.args.kw_defaults,
                    ]
                    for d in defaults:
                        if d is not None and _is_mutable_default(d):
                            yield (
                                d.lineno,
                                d.col_offset,
                                f"mutable default argument on captured "
                                f"function {node.name!r} — shared across "
                                "calls and mutated only at the warm-up "
                                "and the capture; pass it explicitly",
                            )
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    names = ", ".join(node.names)
                    kind = (
                        "global" if isinstance(node, ast.Global)
                        else "nonlocal"
                    )
                    yield (
                        node.lineno,
                        node.col_offset,
                        f"`{kind} {names}` write inside a captured scope "
                        "runs at the warm-up and the capture only, never "
                        "per replay — keep the state in a tensor the "
                        "graph updates",
                    )
