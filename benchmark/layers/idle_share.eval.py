"""The device's idle share in the traced segment, in evaluation cells
(``readings.idle_share``)."""

from benchmark.readings import idle_share as read  # noqa: F401
