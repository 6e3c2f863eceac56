"""Dynamic bandwidth allocation of the TDM-PON, cycle by cycle (host).

Background traffic rides assured T-CONTs; the FL task's traffic is
best-effort unless the slice reserves it a T-CONT:

* :class:`FCFSBestEffort`, the paper's benchmark: each polling cycle the
  background queues are served first, oldest head of line first, and
  the FL queues share what is left, first come first served;
* :class:`SlicedDBA`, the paper's DBA: during the BS slice the slotted
  client's FL queue is served first at the slice bandwidth, and
  background takes the rest.

``efficiency`` is the payload share of the line rate after guard times,
REPORT/GRANT and FEC. Queues are fluid (bits), FIFO per ONU across
kinds. These are the cycle-level oracles' allocators: Python floats in
the order of the JAX package's ``repro.net.dba``, stable sorts included.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler import SlotAssignment

DEFAULT_EFFICIENCY = 0.92        # payload share after guard/REPORT/FEC


def _kind_matches(seg_kind, kind) -> bool:
    """A segment kind is a class (``"bg"``/``"fl"``) or an owner-tagged
    ``(class, client_id)`` tuple; either matches its class."""
    return seg_kind == kind or (
        isinstance(seg_kind, tuple) and seg_kind[0] == kind
    )


@dataclass
class OnuQueue:
    """Per-ONU queue: FIFO of ``[kind, bits, t_arrive]`` segments."""

    onu_id: int
    segments: List[list] = field(default_factory=list)
    hol_time: float = np.inf         # arrival time of head-of-line backlog

    def push(self, kind, bits: float, t: float):
        if bits <= 0:
            return
        if not self.segments:
            self.hol_time = t
        self.segments.append([kind, bits, t])

    @property
    def backlog(self) -> float:
        return sum(s[1] for s in self.segments)

    def backlog_of(self, kind) -> float:
        return sum(s[1] for s in self.segments if _kind_matches(s[0], kind))

    def hol_time_of(self, kind) -> float:
        for s in self.segments:
            if _kind_matches(s[0], kind):
                return s[2]
        return np.inf

    def serve(self, bits: float, kind=None) -> Dict[object, float]:
        """Drain up to ``bits`` from the FIFO head (only ``kind``'s
        segments when given, in their order). Returns the drained bits
        by exact segment kind, owner tags kept. One pass: survivors go
        to a fresh list."""
        served: Dict[object, float] = {}
        remaining = bits
        kept: List[list] = []
        for j, seg in enumerate(self.segments):
            if remaining <= 1e-9:
                kept.extend(self.segments[j:])
                break
            if kind is not None and not _kind_matches(seg[0], kind):
                kept.append(seg)
                continue
            take = min(seg[1], remaining)
            seg[1] -= take
            remaining -= take
            served[seg[0]] = served.get(seg[0], 0.0) + take
            if seg[1] <= 1.0:            # < 1 bit: numerically drained
                remaining = max(0.0, remaining - seg[1])
            else:
                kept.append(seg)
        self.segments = kept
        self.hol_time = kept[0][2] if kept else np.inf
        return served


class FCFSBestEffort:
    """Benchmark DBA: assured background first, FL best-effort FCFS after."""

    def __init__(self, line_rate_bps: float, cycle_time_s: float,
                 n_onus: int, efficiency: float = DEFAULT_EFFICIENCY):
        self.capacity_bits = line_rate_bps * cycle_time_s * efficiency
        self.n_onus = n_onus

    def grant(self, queues: Sequence[OnuQueue],
              cap_bits: Optional[float] = None
              ) -> Dict[int, Dict[str, float]]:
        """``{onu_id: {"bg": bits, "fl": bits}}`` for this cycle;
        ``cap_bits`` caps it below the wavelength capacity (a PON's
        waterfilled share of a shared CPS uplink)."""
        grants: Dict[int, Dict[str, float]] = {}
        cap = self.capacity_bits
        if cap_bits is not None:
            cap = min(cap, cap_bits)

        # assured class: background backlogs, oldest first (stable)
        bg_q = [(q.hol_time_of("bg"), q) for q in queues
                if q.backlog_of("bg") > 0]
        for _, q in sorted(bg_q, key=lambda x: x[0]):
            take = min(q.backlog_of("bg"), cap)
            if take <= 0:
                continue
            grants.setdefault(q.onu_id, {})["bg"] = take
            cap -= take
            if cap <= 1e-9:
                return grants

        # best-effort class: FL queues, FCFS by head-of-line age
        fl_q = [(q.hol_time_of("fl"), q) for q in queues
                if q.backlog_of("fl") > 0]
        for _, q in sorted(fl_q, key=lambda x: x[0]):
            take = min(q.backlog_of("fl"), cap)
            if take <= 0:
                continue
            grants.setdefault(q.onu_id, {})["fl"] = take
            cap -= take
            if cap <= 1e-9:
                break
        return grants


# the paper calls the benchmark simply "FCFS"
FCFSLimitedService = FCFSBestEffort


class SlicedDBA:
    """The paper's DBA: reserved slice grants first, assured bg after."""

    def __init__(self, line_rate_bps: float, cycle_time_s: float,
                 n_onus: int, slice_bandwidth_bps: float,
                 slots: Sequence[SlotAssignment],
                 efficiency: float = DEFAULT_EFFICIENCY):
        self.capacity_bits = line_rate_bps * cycle_time_s * efficiency
        self.cycle_time_s = cycle_time_s
        self.slice_rate = slice_bandwidth_bps
        self.slots = sorted(slots, key=lambda s: s.t_start)
        self.fcfs = FCFSBestEffort(line_rate_bps, cycle_time_s, n_onus,
                                   efficiency)

    def active_slots(self, t_cycle: float) -> List[SlotAssignment]:
        # one extra cycle of grace absorbs cycle-quantisation float error
        t_end = t_cycle + self.cycle_time_s
        return [
            s
            for s in self.slots
            if s.t_start < t_end and s.t_end + self.cycle_time_s > t_cycle
        ]

    def grant(self, queues: Sequence[OnuQueue], t_cycle: float,
              cap_bits: Optional[float] = None
              ) -> Dict[int, Dict[str, float]]:
        """``{onu_id: {"fl": bits, "bg": bits}}`` for this cycle. FL rides
        only in its slice slots (a dedicated T-CONT); background is
        assured from the remaining capacity. ``cap_bits`` as in
        :meth:`FCFSBestEffort.grant`."""
        grants: Dict[int, Dict[str, float]] = {}
        by_id = {q.onu_id: q for q in queues}
        cap_total = self.capacity_bits
        if cap_bits is not None:
            cap_total = min(cap_total, cap_bits)
        reserved_spent = 0.0
        for slot in self.active_slots(t_cycle):
            q = by_id.get(slot.client_id)
            if q is None:
                continue
            overlap = min(
                slot.t_end + self.cycle_time_s, t_cycle + self.cycle_time_s
            ) - max(slot.t_start, t_cycle)
            fl_bits = min(
                self.slice_rate * max(overlap, 0.0),
                q.backlog_of("fl"),
                cap_total - reserved_spent,
            )
            if fl_bits > 0:
                g = grants.setdefault(slot.client_id, {})
                g["fl"] = g.get("fl", 0.0) + fl_bits
                reserved_spent += fl_bits
        # assured background from the remaining capacity, oldest first
        cap = cap_total - reserved_spent
        bg_q = [(q.hol_time_of("bg"), q) for q in queues
                if q.backlog_of("bg") > 0]
        for _, q in sorted(bg_q, key=lambda x: x[0]):
            take = min(q.backlog_of("bg"), cap)
            if take <= 0:
                continue
            g = grants.setdefault(q.onu_id, {})
            g["bg"] = g.get("bg", 0.0) + take
            cap -= take
            if cap <= 1e-9:
                break
        return grants
