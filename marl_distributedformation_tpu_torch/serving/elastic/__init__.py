"""Elastic capacity: the live re-split control loop (controller.py)."""

from marl_distributedformation_tpu_torch.serving.elastic.controller import (
    CapacityController,
    CapacityDecision,
)

__all__ = ["CapacityController", "CapacityDecision"]
