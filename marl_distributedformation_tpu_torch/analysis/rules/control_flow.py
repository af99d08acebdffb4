"""traced-python-control-flow: ``if``/``while`` on a tensor in a captured
scope.

A Python condition on a tensor calls ``bool`` on it: a device->host sync
the capture does not allow, and the branch the warm-up took is the one
the graph records, replayed whatever the tensor holds later. The fix is
``torch.where`` (or a masked update) so the choice stays on the device.
Host predicates (``x is None``, ``x.shape[0] > 2``, ``x.device.type``,
``isinstance(...)``, config flags) stay allowed — see the taint rules in
``linter.ModuleContext``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
)

_FIX = {
    ast.If: "torch.where or a masked update",
    ast.IfExp: "torch.where",
    ast.While: "a fixed trip count with a masked update",
}


class TracedPythonControlFlow(Rule):
    name = "traced-python-control-flow"
    default_severity = "error"
    description = (
        "Python if/while on a tensor inside a captured scope (a "
        "PhaseGraph's fn) — a sync the capture does not allow, and the "
        "warm-up's branch is replayed forever"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for root in ctx.traced_roots:
            taint = ctx.taint_for(root)
            for node in ast.walk(root):
                if not isinstance(node, (ast.If, ast.IfExp, ast.While)):
                    continue
                if ctx.expr_tainted(node.test, taint):
                    kind = (
                        "while" if isinstance(node, ast.While) else "if"
                    )
                    yield (
                        node.test.lineno,
                        node.test.col_offset,
                        f"Python `{kind}` on a tensor inside a captured "
                        f"scope — use {_FIX[type(node)]} so the choice "
                        "stays on the device and is made on every replay",
                    )
