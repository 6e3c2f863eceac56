"""Slot scheduling inside the BS slice (host Python).

The port's own copy of ``repro.core.scheduler``: earliest-ready-first
fixed slots packed back to back at the slice bandwidth, the slot plan
as parallel arrays (the form the cycle engine consumes), its quantisation
into per-polling-cycle grants and the schedule's invariants.
"""
from __future__ import annotations

import math
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


@dataclass(frozen=True)
class CycleGrant:
    cycle_index: int
    t_cycle_start: float
    client_id: int
    bits: float


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


def schedule_makespan(slots: Sequence[SlotAssignment]) -> float:
    return max(s.t_end for s in slots) if slots else 0.0


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


def map_to_polling_cycles(
    slots: Sequence[SlotAssignment],
    spec: SliceSpec,
    cycle_time_s: float = 1e-3,
) -> List[CycleGrant]:
    """The slot plan as per-polling-cycle grants: a slot spanning
    ``[a, b)`` is granted, in every cycle it overlaps, the overlap at the
    slice bandwidth."""
    grants: List[CycleGrant] = []
    if not slots:
        return grants
    t0 = min(s.t_start for s in slots)
    for s in slots:
        first = int(math.floor((s.t_start - t0) / cycle_time_s))
        last = int(math.ceil((s.t_end - t0) / cycle_time_s))
        for idx in range(first, last):
            c_start = t0 + idx * cycle_time_s
            c_end = c_start + cycle_time_s
            overlap = min(s.t_end, c_end) - max(s.t_start, c_start)
            if overlap <= 0:
                continue
            grants.append(CycleGrant(
                cycle_index=idx, t_cycle_start=c_start,
                client_id=s.client_id, bits=overlap * spec.bandwidth_bps,
            ))
    return grants


def validate_schedule(
    clients: Sequence[ClientProfile],
    slots: Sequence[SlotAssignment],
    spec: SliceSpec,
    round_start: float,
    tol: float = 1e-6,
) -> None:
    """Assert the schedule's invariants: one slot a client carrying its
    update bits, none before the client is ready or the slice opens, no
    two overlapping, each draining at the slice bandwidth."""
    by_id = {c.client_id: c for c in clients}
    assert len(slots) == len(clients), "one slot per client"
    prev_end = -float("inf")
    for s in sorted(slots, key=lambda s: s.t_start):
        c = by_id[s.client_id]
        assert s.bits == c.m_ud_bits
        assert s.t_start >= round_start + c.delta - tol, \
            "slot before readiness"
        assert s.t_start >= spec.t_start - tol, "slot before slice opens"
        assert s.t_start >= prev_end - tol, "overlapping slots"
        expected = s.bits / spec.bandwidth_bps
        assert abs(s.duration - expected) < tol * max(1.0, expected)
        prev_end = s.t_end
