"""Deterministic, counter-based fault injection for the co-simulation.

The port of ``repro.faults``: :mod:`repro_torch.faults.model` (the fault
and retry model) and :mod:`repro_torch.faults.streams` (the
threefry-keyed decision streams).
"""
from repro_torch.faults.model import FaultSchedule, RetryPolicy
from repro_torch.faults.streams import (
    FAULT_DROPOUT,
    FAULT_LOSS,
    FAULT_OUTAGE,
    fault_fingerprint,
    fault_key,
    fault_uniforms,
)

__all__ = [
    "FaultSchedule",
    "RetryPolicy",
    "FAULT_DROPOUT",
    "FAULT_LOSS",
    "FAULT_OUTAGE",
    "fault_fingerprint",
    "fault_key",
    "fault_uniforms",
]
