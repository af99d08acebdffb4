"""blocking-transfer-in-actor-loop: a sync on the acting critical path.

The Sebulba split (``train/sebulba/``) only pays off while the actor lane
stays a pure launch pipeline: snapshot the parameters, replay the
rollout graph, enqueue the trajectory, repeat. PyTorch keeps that
pipeline deep by launching asynchronously, which one synchronous call
collapses::

    while not stop:                          # the actor loop
        self._actor_phase()
        torch.cuda.synchronize()             # <- the lane idles the card
        queue.put(batch.cpu())               # <- a device->host round trip

The fix is always the seam: hand the device tensors to the
``TransferQueue``, whose slots are ordered by CUDA events, and drain
metrics at the learner's chunk boundary.

Scope, deliberately narrow: host ``while``/``for`` loops (outside captured
scopes) whose enclosing function or class name contains ``actor`` or
``transfer``. Flagged inside such a loop body:

- ``torch.cuda.synchronize()`` and a stream's or an event's
  ``.synchronize()``;
- the host copies ``.cpu()`` / ``.item()`` / ``.tolist()`` /
  ``.numpy()``;
- a plain-name call into a SAME-MODULE helper that makes one of those
  calls (one hop, ``first_hops={"local"}``). Method calls are not
  followed: the TransferQueue/ParamBus seams are methods called from
  actor loops, and following them would flag the homes this rule steers
  toward.
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

_BLOCKING_CALLS = frozenset({"torch.cuda.synchronize"})
_BLOCKING_METHODS = frozenset({"synchronize", "cpu", "item", "tolist",
                               "numpy"})
_SCOPE_MARKERS = ("actor", "transfer")
_NAME_HOPS = frozenset({"local"})


def _blocking_pred(node: ast.Call, fname) -> Optional[str]:
    if fname in _BLOCKING_CALLS:
        return fname
    if isinstance(node.func, ast.Attribute) and (
        node.func.attr in _BLOCKING_METHODS and not node.args
    ):
        return f".{node.func.attr}"
    return None


class BlockingTransferInActorLoop(Rule):
    name = "blocking-transfer-in-actor-loop"
    default_severity = "error"
    description = (
        "torch.cuda.synchronize / .synchronize() / a host copy (.cpu(), "
        ".item()) inside an actor or transfer-queue loop body — a device "
        "sync per rollout on the acting critical path; hand the device "
        "tensors to the transfer-queue seam"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        reported: Set[Tuple[int, int]] = set()
        for loop in self._actor_loops(ctx):
            for hit in self._scan_body(ctx, loop):
                if hit[:2] not in reported:
                    reported.add(hit[:2])
                    yield hit

    def _actor_loops(self, ctx: ModuleContext) -> List[ast.AST]:
        return [
            node
            for node in ast.walk(ctx.tree)
            if isinstance(node, (ast.While, ast.For))
            and not ctx._has_traced_ancestor(node)
            and self._in_actor_scope(ctx, node)
        ]

    @staticmethod
    def _in_actor_scope(ctx: ModuleContext, loop: ast.AST) -> bool:
        for anc in ctx._ancestors(loop):
            if isinstance(
                anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                name = anc.name.lower()
                if any(marker in name for marker in _SCOPE_MARKERS):
                    return True
        return False

    def _scan_body(
        self, ctx: ModuleContext, loop: ast.AST
    ) -> Iterator[Tuple[int, int, str]]:
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_traced_scope(node) is not None:
                continue  # a captured body defined inside the loop
            fname = dotted_name(node.func)
            direct = _blocking_pred(node, fname)
            if direct is not None:
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{direct}(...) inside an actor/transfer loop "
                    "synchronizes the acting lane every iteration — "
                    "enqueue the device tensors through the transfer-queue "
                    "seam (its slots are ordered by CUDA events) and drain "
                    "host values at the learner's chunk boundary",
                )
            elif isinstance(node.func, ast.Name):
                hit = callgraph.reachable_call(
                    ctx, node, _blocking_pred, first_hops=_NAME_HOPS
                )
                if hit is not None:
                    yield (
                        node.lineno,
                        node.col_offset,
                        f"{node.func.id}() is called from an "
                        f"actor/transfer loop and reaches "
                        f"{hit.matched}(...) — a device sync per "
                        "iteration on the acting critical path; move the "
                        "transfer to the queue's enqueue seam",
                    )
