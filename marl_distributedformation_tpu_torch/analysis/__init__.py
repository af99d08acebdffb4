"""Program-build guards (counterpart of the JAX package's ``analysis/``):
``RetraceGuard`` counts a program's builds (a CUDA graph capture on the
card, the eager step's construction on the CPU) and raises
``RetraceError`` past its budget; ``guards.py`` also registers programs
with the ledger. The runtime guards ``nan_guard`` and
``no_host_transfers`` and the static linter are still to be ported
(ROADMAP A14)."""

from marl_distributedformation_tpu_torch.analysis.guards import (  # noqa: F401
    RetraceError,
    RetraceGuard,
)
