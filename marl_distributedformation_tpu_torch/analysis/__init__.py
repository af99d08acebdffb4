"""graftlint for the port: capture-hygiene static analysis, and the
program-build and runtime guards.

Counterpart of the JAX package's ``analysis/``:

- **static** (``linter.py`` + ``rules/`` + ``callgraph.py``): an AST
  linter whose "traced scope" is a CUDA graph capture — the ``fn`` of a
  ``PhaseGraph``, the phases of a ``phase_fns()`` and what they reach
  across the package. Host code there runs at the warm-up and the capture
  and never on a replay, and on the CPU (``capture=False``) it runs every
  call, so no CPU test can see it: the linter is the tier-1 guard. The
  CLI is ``python -m marl_distributedformation_tpu_torch.analysis
  [--check] [--format sarif] [paths...]``; it is pure AST and imports
  neither torch nor the linted tree.
- **runtime** (``guards.py``): ``RetraceGuard`` counts a program's builds
  (a CUDA graph capture on the card, the eager step's construction on the
  CPU) and raises ``RetraceError`` past its budget; ``guards.py`` also
  registers programs with the ledger. ``no_host_transfers`` (the CUDA
  sync debug mode) and ``nan_guard`` (a dispatch mode naming the op that
  made a NaN) are the trainer's runtime guards. They load on first use,
  so the CLI never runs them.
"""

from marl_distributedformation_tpu_torch.analysis.config import (  # noqa: F401
    GraftlintConfig,
    load_config,
)
from marl_distributedformation_tpu_torch.analysis.linter import (  # noqa: F401
    Violation,
    lint_paths,
    lint_source,
)

_GUARDS = ("RetraceError", "RetraceGuard", "nan_guard", "no_host_transfers")


def __getattr__(name):
    if name in _GUARDS:
        from marl_distributedformation_tpu_torch.analysis import guards

        return getattr(guards, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted({*globals(), *_GUARDS})
