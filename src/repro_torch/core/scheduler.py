"""Slot scheduling inside the BS slice (host Python).

The port's own copy of ``repro.core.scheduler``: earliest-ready-first
fixed slots packed back to back at the slice bandwidth, and the slot
plan as parallel arrays, the form the cycle engine consumes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.slicing import ClientProfile, SliceSpec


@dataclass(frozen=True)
class SlotAssignment:
    client_id: int
    t_start: float          # absolute time the slot opens
    t_end: float            # absolute time the slot closes
    bits: float

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


def schedule_slots(
    clients: Sequence[ClientProfile],
    spec: SliceSpec,
    round_start: float,
) -> List[SlotAssignment]:
    """Earliest-ready-first slots: a client starts no earlier than
    max(slice start, its readiness ``round_start + Δ_i``)."""
    order = sorted(clients, key=lambda c: c.delta)
    slots: List[SlotAssignment] = []
    cursor = spec.t_start
    for c in order:
        ready = round_start + c.delta
        start = max(cursor, ready)
        dur = c.m_ud_bits / spec.bandwidth_bps
        slots.append(SlotAssignment(
            client_id=c.client_id, t_start=start, t_end=start + dur,
            bits=c.m_ud_bits,
        ))
        cursor = start + dur
    return slots


def slots_to_arrays(slots: Sequence[SlotAssignment]
                    ) -> Dict[str, np.ndarray]:
    """Slot schedule as parallel arrays, stably sorted by ``t_start``."""
    order = sorted(range(len(slots)), key=lambda i: slots[i].t_start)
    return {
        "t_start": np.array([slots[i].t_start for i in order], np.float64),
        "t_end": np.array([slots[i].t_end for i in order], np.float64),
        "client_id": np.array([slots[i].client_id for i in order],
                              np.int64),
        "bits": np.array([slots[i].bits for i in order], np.float64),
    }
