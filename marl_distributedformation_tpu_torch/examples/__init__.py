"""Runnable examples of the port's API (``python -m
marl_distributedformation_tpu_torch.examples.<name>``)."""
