"""The policy's matmul FLOPs over the window as a share of the card's
float32 peak, in evaluation cells (``readings.mfu``)."""

from benchmark.readings import mfu as read  # noqa: F401
