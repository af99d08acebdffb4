"""graftlint rule registry. Rules are stateless between files (any
per-check state is reset inside ``check``), so one shared instance per
rule serves every lint run.

The rules keep the JAX package's names where the hazard carries over to
a CUDA graph capture. ``NO_COUNTERPART`` names each JAX rule that has
none in the port, with the reason."""

from typing import Dict, List

from marl_distributedformation_tpu_torch.analysis.linter import Rule
from marl_distributedformation_tpu_torch.analysis.rules.actor_transfer import (
    BlockingTransferInActorLoop,
)
from marl_distributedformation_tpu_torch.analysis.rules.capture import (
    MutableCaptureInJit,
)
from marl_distributedformation_tpu_torch.analysis.rules.control_flow import (
    TracedPythonControlFlow,
)
from marl_distributedformation_tpu_torch.analysis.rules.dispatch_transfer import (  # noqa: E501
    DevicePutInDispatchLoop,
)
from marl_distributedformation_tpu_torch.analysis.rules.env_contract import (
    EnvContractImpurity,
)
from marl_distributedformation_tpu_torch.analysis.rules.f64_promotion import (
    ImplicitF64Promotion,
)
from marl_distributedformation_tpu_torch.analysis.rules.fault_scope import (
    FaultPointInTracedScope,
)
from marl_distributedformation_tpu_torch.analysis.rules.graftlock import (
    BlockingCallUnderDispatchLock,
    LockOrderingCycle,
    LockReleasedAcrossAwaitSeam,
    UnguardedSharedMutation,
)
from marl_distributedformation_tpu_torch.analysis.rules.host_sync import (
    HostSyncInJit,
)
from marl_distributedformation_tpu_torch.analysis.rules.ledger_scope import (
    LedgerRecordInTracedScope,
)
from marl_distributedformation_tpu_torch.analysis.rules.metrics_scope import (
    MetricsInTracedScope,
)
from marl_distributedformation_tpu_torch.analysis.rules.nonfinite_probe import (  # noqa: E501
    HostNonfiniteProbeInDispatchLoop,
)
from marl_distributedformation_tpu_torch.analysis.rules.numpy_use import (
    NumpyInJit,
)
from marl_distributedformation_tpu_torch.analysis.rules.printing import (
    PrintInJit,
)
from marl_distributedformation_tpu_torch.analysis.rules.prng import (
    PrngKeyReuse,
)
from marl_distributedformation_tpu_torch.analysis.rules.rpc_scope import (
    RpcInTracedScope,
)
from marl_distributedformation_tpu_torch.analysis.rules.search_compare import (  # noqa: E501
    TracedComparisonInSearch,
)
from marl_distributedformation_tpu_torch.analysis.rules.span_scope import (
    SpanInTracedScope,
)

RULES = (
    NumpyInJit(),
    TracedPythonControlFlow(),
    PrngKeyReuse(),
    HostSyncInJit(),
    MutableCaptureInJit(),
    PrintInJit(),
    ImplicitF64Promotion(),
    SpanInTracedScope(),
    DevicePutInDispatchLoop(),
    TracedComparisonInSearch(),
    MetricsInTracedScope(),
    FaultPointInTracedScope(),
    LedgerRecordInTracedScope(),
    RpcInTracedScope(),
    HostNonfiniteProbeInDispatchLoop(),
    LockOrderingCycle(),
    UnguardedSharedMutation(),
    BlockingCallUnderDispatchLock(),
    LockReleasedAcrossAwaitSeam(),
    BlockingTransferInActorLoop(),
    EnvContractImpurity(),
)

# The JAX package's rules with no counterpart here, and why.
NO_COUNTERPART: Dict[str, str] = {
    "missing-donate": (
        "a CUDA graph reuses its static buffers in place, and torch has "
        "no donate_argnums"
    ),
    "vmap-in-axes-arity": "the port has no vmap",
    "scan-carry-weak-type": "the port has no lax.scan carry",
    "scan-carry-sharding-drift": (
        "the port has no lax.scan and no sharding constraints"
    ),
    "callback-in-hot-loop": (
        "a torch capture has no host callback (io_callback, "
        "jax.debug.print); host calls reachable from a captured scope are "
        "the scope rules' and the call graph's"
    ),
    "cross-module-callback": (
        "a torch capture has no host callback; the scope rules over the "
        "call graph's captured closure (analysis/callgraph.py) cover host "
        "calls reachable across modules"
    ),
    "deprecated-api": (
        "its allow/deny table is of JAX spellings (shard_map, pjit, "
        "tree_map)"
    ),
}


def all_rules() -> List[Rule]:
    return list(RULES)


def rule_names() -> List[str]:
    return [r.name for r in RULES]
