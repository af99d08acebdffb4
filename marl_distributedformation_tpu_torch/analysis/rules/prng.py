"""prng-key-reuse: a draw in a captured scope from a generator the graph
does not advance.

A CUDA graph records a random draw as a kernel with the generator's
seed and offset of the capture. A generator registered with the graph
(``PhaseGraph(..., generators=...)``, which calls
``register_generator_state``) moves on at every replay, as eager calls
would; any other explicit generator does not: every replay reuses the
capture's numbers. In PPO that silently repeats the same action noise or
minibatch permutation every iteration, which trains but converges to the
wrong policy — the counterpart of JAX's reused key. On the CPU
(``capture=False``) the draws advance and no test sees it.

The rule reads each ``PhaseGraph(...)`` whose ``generators`` argument is
a literal list or tuple (or absent, so none), and flags a draw with an
explicit ``generator=`` inside its ``fn`` (and the closures in it) whose
generator is not one of them. Draws without ``generator=`` use the
device's default generator, which the capture registers itself; a
``generators`` argument that is not a literal cannot be judged and stays
clean.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
    is_phase_graph_call,
    phase_graph_arg,
)

# torch functions and tensor methods that draw random numbers.
_DRAW_FUNCTIONS = frozenset(
    {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
     "multinomial", "poisson", "rand_like", "randn_like", "randint_like"}
)
_DRAW_METHODS = frozenset(
    {"uniform_", "normal_", "exponential_", "random_", "bernoulli_",
     "geometric_", "log_normal_", "cauchy_"}
)


def _generator_of(call: ast.Call) -> Optional[ast.expr]:
    """The explicit ``generator=`` of a random draw, if it is one."""
    fname = dotted_name(call.func) or ""
    is_draw = (fname.startswith("torch.")
               and fname.rsplit(".", 1)[-1] in _DRAW_FUNCTIONS) or (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _DRAW_METHODS)
    if not is_draw:
        return None
    for kw in call.keywords:
        if kw.arg == "generator":
            return kw.value
    return None


class PrngKeyReuse(Rule):
    name = "prng-key-reuse"
    default_severity = "error"
    description = (
        "a draw inside a PhaseGraph's fn from a generator the PhaseGraph "
        "was not given in generators — every replay reuses the capture's "
        "numbers; register the generator with the graph"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        seen: Set[Tuple[int, int]] = set()
        for call in ast.walk(ctx.tree):
            if not is_phase_graph_call(call):
                continue
            fn = phase_graph_arg(call, 1, "fn")
            gens = phase_graph_arg(call, 2, "generators")
            if fn is None:
                continue
            if gens is None:
                registered: Set[str] = set()
            elif isinstance(gens, (ast.List, ast.Tuple)):
                registered = {ast.unparse(g) for g in gens.elts}
            else:
                continue
            for scope in ctx._resolve_callable(fn, call):
                for node in ast.walk(scope):
                    if not isinstance(node, ast.Call):
                        continue
                    gen = _generator_of(node)
                    if gen is None or ast.unparse(gen) in registered:
                        continue
                    pos = (node.lineno, node.col_offset)
                    if pos in seen:
                        continue
                    seen.add(pos)
                    yield (
                        *pos,
                        f"draw from generator {ast.unparse(gen)!r} inside "
                        f"the fn of the PhaseGraph on line {call.lineno}, "
                        "which does not register it (generators="
                        f"{ast.unparse(gens) if gens is not None else '()'}"
                        ") — every replay reuses the capture's numbers; "
                        "pass the generator in generators",
                    )
