"""The chaos plane: deterministic fault injection at host seams.

Counterpart of the JAX package's ``chaos/plane.py``: production seams
call :func:`fault_point` (one attribute read when the plane is disabled,
the shipped default), and a seeded :class:`FaultSchedule` arms faults at
them. The invariant checkers and the lane watchdog are not ported yet
(ROADMAP A13).
"""

from marl_distributedformation_tpu_torch.chaos.plane import (
    DISRUPTIVE_KINDS,
    FAULT_KINDS,
    INJECTION_POINTS,
    FaultPlane,
    FaultSchedule,
    FaultSpec,
    InjectedFault,
    SimulatedCrash,
    configure_chaos,
    fault_point,
    get_fault_plane,
    set_fault_plane,
)

__all__ = [
    "DISRUPTIVE_KINDS",
    "FAULT_KINDS",
    "INJECTION_POINTS",
    "FaultPlane",
    "FaultSchedule",
    "FaultSpec",
    "InjectedFault",
    "SimulatedCrash",
    "configure_chaos",
    "fault_point",
    "get_fault_plane",
    "set_fault_plane",
]
