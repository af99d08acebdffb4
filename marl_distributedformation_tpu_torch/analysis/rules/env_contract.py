"""env-contract-impurity: host impurity inside an env step/reset.

The env contract (``envs/spec.py``) requires ``reset`` / ``step`` and the
batched ``*_batch`` functions to draw all randomness from the
``torch.Generator`` they are handed, and to close over no mutable host
state: the trainer captures them in its rollout graph. An env that draws
from the HOST RNG (``np.random.*`` / stdlib ``random.*``) draws once at
the warm-up and once at the capture and bakes the sample into the graph
— every replay uses the same "random" value, which trains and evaluates
without error on silently degenerate data. A ``global`` statement in a
step is the same bug from the other side: the rebind happens at the
capture only.

Detection is name-scoped: functions named ``step`` / ``reset`` or ending
in ``step_batch`` / ``reset_batch`` (the contract's field names), and
every function nested in one. Host RNG aliases are resolved from the
module's imports, so ``torch.random`` never collides with stdlib
``random``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

_ENV_FN_NAMES = frozenset({"step", "reset"})
_ENV_FN_SUFFIXES = ("step_batch", "reset_batch")


def _host_rng_aliases(tree: ast.Module) -> Set[str]:
    """Dotted prefixes denoting the HOST RNG in this module: stdlib
    ``random`` and ``numpy.random`` under whatever names they were
    imported as."""
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random":
                    aliases.add(a.asname or "random")
                elif a.name == "numpy":
                    aliases.add(f"{a.asname or 'numpy'}.random")
                elif a.name == "numpy.random":
                    aliases.add(a.asname or "numpy.random")
        elif isinstance(node, ast.ImportFrom) and node.module == "numpy":
            for a in node.names:
                if a.name == "random":
                    aliases.add(a.asname or "random")
    return aliases


class EnvContractImpurity(Rule):
    name = "env-contract-impurity"
    default_severity = "error"
    description = (
        "an env step/reset draws from the host RNG or rebinds a global — "
        "the draw is baked into the captured rollout; draw from the "
        "torch.Generator the env is handed"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        aliases = _host_rng_aliases(ctx.tree)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in _ENV_FN_NAMES and not fn.name.endswith(
                    _ENV_FN_SUFFIXES):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Global):
                    yield (
                        node.lineno,
                        node.col_offset,
                        f"env function {fn.name!r} rebinds global(s) "
                        f"{', '.join(node.names)} — the rebind happens at "
                        "the capture only; carry the value in the env "
                        "state",
                    )
                elif isinstance(node, ast.Call):
                    fname = dotted_name(node.func) or ""
                    head = fname.rpartition(".")[0]
                    if head in aliases:
                        yield (
                            node.lineno,
                            node.col_offset,
                            f"env function {fn.name!r} calls host RNG "
                            f"{fname}() — the sample is baked into the "
                            "captured rollout; draw from the env's "
                            "torch.Generator",
                        )


__all__ = ["EnvContractImpurity"]
