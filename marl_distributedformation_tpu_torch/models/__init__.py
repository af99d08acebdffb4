"""Actor-critic models as ``nn.Module``s (MLP, CTDE and GNN)."""

from marl_distributedformation_tpu_torch.models import distributions  # noqa: F401
from marl_distributedformation_tpu_torch.models.ctde import CTDEActorCritic  # noqa: F401
from marl_distributedformation_tpu_torch.models.gnn import GNNActorCritic  # noqa: F401
from marl_distributedformation_tpu_torch.models.mlp import MLPActorCritic  # noqa: F401
