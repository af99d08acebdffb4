"""Program-build and runtime guards (counterpart of the JAX package's
``analysis/``): ``RetraceGuard`` counts a program's builds (a CUDA graph
capture on the card, the eager step's construction on the CPU) and raises
``RetraceError`` past its budget; ``guards.py`` also registers programs
with the ledger. ``no_host_transfers`` (the CUDA sync debug mode) and
``nan_guard`` (a dispatch mode naming the op that made a NaN) are the
trainer's runtime guards. The static linter is still to be ported
(ROADMAP A14)."""

from marl_distributedformation_tpu_torch.analysis.guards import (  # noqa: F401
    RetraceError,
    RetraceGuard,
    nan_guard,
    no_host_transfers,
)
