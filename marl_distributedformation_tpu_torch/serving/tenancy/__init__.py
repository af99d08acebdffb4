"""Multi-tenant serving: named model lanes over one fleet.

Counterpart of the JAX package's ``serving/tenancy/``. ``TenantDirectory``
declares the lanes, ``TenantFleet`` serves them: same-arch lanes share one
engine a replica and its captured rungs (a lane's parameters are copied
into the rungs' tensors at dispatch), every lane gets its own admission
queue, its own reload coordinator and its own monotonic step.
"""

from marl_distributedformation_tpu_torch.serving.tenancy.directory import (
    TenantDirectory,
    TenantSpec,
)
from marl_distributedformation_tpu_torch.serving.tenancy.fleet import (
    TenantFleet,
    tenant_fleet_from_directory,
)
from marl_distributedformation_tpu_torch.serving.tenancy.smoke import (
    run_tenant_smoke,
)

__all__ = [
    "TenantDirectory",
    "TenantSpec",
    "TenantFleet",
    "tenant_fleet_from_directory",
    "run_tenant_smoke",
]
