"""Actor-critic models as ``nn.Module``s (MLP and GNN)."""

from marl_distributedformation_tpu_torch.models import distributions  # noqa: F401
from marl_distributedformation_tpu_torch.models.gnn import GNNActorCritic  # noqa: F401
from marl_distributedformation_tpu_torch.models.mlp import MLPActorCritic  # noqa: F401
