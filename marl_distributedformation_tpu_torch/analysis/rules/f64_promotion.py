"""implicit-f64-promotion: float64 reaching the f32 math of a captured
scope.

The port computes in float32, as the JAX package does with x64 off. A
float64 tensor made inside a body a ``PhaseGraph`` captures
(``dtype=torch.float64``, ``.double()``, ``.to(torch.float64)``, or
``torch.from_numpy`` / ``torch.as_tensor`` of a numpy array that defaults
to float64, such as ``np.zeros(n)`` or ``np.array([0.5])``) promotes every
expression it meets: the graph runs f64 kernels at a fraction of the
card's f32 rate, and its outputs no longer match the reference's f32
rounding. Bare float literals (``x * 0.5``) keep the tensor's dtype and
stay clean.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from marl_distributedformation_tpu_torch.analysis.linter import (
    ModuleContext,
    Rule,
    dotted_name,
)

_F64_NAMES = frozenset(
    {"torch.float64", "torch.double", "np.float64", "numpy.float64",
     "np.double", "numpy.double", "float"}
)
_F64_DTYPE_STRINGS = frozenset({"float64", "f8", "<f8", ">f8", "double"})
_F64_CASTS = frozenset({"double"})
_FROM_NUMPY = frozenset({"torch.from_numpy", "torch.as_tensor",
                         "torch.tensor"})
# numpy constructors whose result dtype defaults to float64: always for
# the shape-taking ones, and whenever a float literal is among the data
# for the value-taking ones.
_ALWAYS_F64_PRODUCERS = frozenset(
    {"np.ones", "numpy.ones", "np.zeros", "numpy.zeros",
     "np.empty", "numpy.empty"}
)
_FLOAT_DATA_F64_PRODUCERS = frozenset(
    {"np.array", "numpy.array", "np.asarray", "numpy.asarray",
     "np.arange", "numpy.arange", "np.linspace", "numpy.linspace",
     "np.full", "numpy.full"}
)


def _names_f64(node: ast.AST) -> bool:
    if dotted_name(node) in _F64_NAMES:
        return True
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value in _F64_DTYPE_STRINGS
    )


def _dtype_keyword(call: ast.Call) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


def _f64_producer(node: ast.AST) -> Optional[str]:
    """The numpy call that makes ``node`` a float64 array by default."""
    if not isinstance(node, ast.Call):
        return None
    fname = dotted_name(node.func)
    if not fname or _dtype_keyword(node) is not None:
        return None
    if fname in _ALWAYS_F64_PRODUCERS:
        return fname
    if fname in _FLOAT_DATA_F64_PRODUCERS and any(
        isinstance(n, ast.Constant) and isinstance(n.value, float)
        for a in node.args for n in ast.walk(a)
    ):
        return fname
    return None


class ImplicitF64Promotion(Rule):
    name = "implicit-f64-promotion"
    default_severity = "error"
    description = (
        "float64 made inside a captured scope (torch.float64, .double(), "
        "torch.from_numpy of an f64 array) — promotes the graph's f32 "
        "math; pin torch.float32"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        for root in ctx.traced_roots:
            seen: Set[int] = set()
            for node in ast.walk(root):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                hit = self._f64(node)
                if hit:
                    seen.add(id(node))
                    yield (node.lineno, node.col_offset, hit)

    @staticmethod
    def _f64(node: ast.Call) -> Optional[str]:
        fname = dotted_name(node.func)
        dtype = _dtype_keyword(node)
        if dtype is not None and _names_f64(dtype):
            return (
                f"dtype={ast.unparse(dtype)} makes a float64 tensor inside "
                "a captured scope — it promotes the graph's f32 math; pin "
                "torch.float32"
            )
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _F64_CASTS and not node.args:
                return (
                    ".double() casts to float64 inside a captured scope — "
                    "it promotes the graph's f32 math"
                )
            if node.func.attr in ("to", "type", "astype") and any(
                _names_f64(a) for a in node.args
            ):
                return (
                    f".{node.func.attr}({ast.unparse(node.args[0])}) casts "
                    "to float64 inside a captured scope — it promotes the "
                    "graph's f32 math"
                )
        if fname in _FROM_NUMPY and node.args and dtype is None:
            producer = _f64_producer(node.args[0])
            if producer:
                return (
                    f"{fname}({producer}(...)) makes a float64 tensor "
                    "inside a captured scope (numpy defaults to float64) — "
                    "pass dtype=np.float32 to the array"
                )
        return None
