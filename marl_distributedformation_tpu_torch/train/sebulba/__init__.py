"""Sebulba: split acting from learning.

Counterpart of the JAX package's ``train/sebulba/``: an actor lane replays
the captured rollout phase against published parameter snapshots, a
learner lane drains K trajectory batches a chunk through the captured
update phases, and host-side plumbing (:class:`TransferQueue`,
:class:`ParamBus`) joins them. Selected by ``TrainConfig.architecture =
"sebulba"``.
"""

from marl_distributedformation_tpu_torch.train.sebulba.driver import (
    SebulbaDriver,
    partition_devices,
)
from marl_distributedformation_tpu_torch.train.sebulba.queues import (
    ParamBus,
    TransferItem,
    TransferQueue,
)

__all__ = [
    "ParamBus",
    "SebulbaDriver",
    "TransferItem",
    "TransferQueue",
    "partition_devices",
]
