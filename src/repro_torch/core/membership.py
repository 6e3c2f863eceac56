"""Elastic client membership: the BS re-trigger (paper §2), host Python.

The port's own copy of ``repro.core.membership``. The slice is computed
again only when a client joins or leaves the FL task; every other round
reuses it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.slicing import ClientProfile, SliceSpec, compute_slice


@dataclass
class MembershipEvent:
    time: float
    kind: str                   # "join" | "leave"
    client: ClientProfile


@dataclass
class SliceManager:
    """Owns the current slice; recomputes it only on membership change."""

    capacity_bps: float
    t_round: float
    clients: Dict[int, ClientProfile] = field(default_factory=dict)
    current_slice: Optional[SliceSpec] = None
    recompute_count: int = 0
    event_log: List[MembershipEvent] = field(default_factory=list)

    def bootstrap(self, clients: Sequence[ClientProfile], t_now: float = 0.0):
        self.clients = {c.client_id: c for c in clients}
        self._retrigger(t_now)

    def join(self, client: ClientProfile, t_now: float):
        self.event_log.append(MembershipEvent(t_now, "join", client))
        self.clients[client.client_id] = client
        self._retrigger(t_now)

    def leave(self, client_id: int, t_now: float):
        client = self.clients.pop(client_id, None)
        if client is None:
            return                      # unknown client: no re-trigger
        self.event_log.append(MembershipEvent(t_now, "leave", client))
        if self.clients:
            self._retrigger(t_now)
        else:
            self.current_slice = None

    def on_round(self, t_now: float) -> Optional[SliceSpec]:
        """The slice for this round, without recomputing it."""
        return self.current_slice

    def _retrigger(self, t_now: float):
        if not self.clients:
            self.current_slice = None
            return
        self.current_slice = compute_slice(
            list(self.clients.values()), t_current=t_now,
            t_round=self.t_round, capacity_bps=self.capacity_bps, h=1,
        )
        self.recompute_count += 1

    @property
    def profile_set(self) -> List[ClientProfile]:
        return list(self.clients.values())
