"""Deadline-driven client selection — the paper's reference [4] baseline
(Nishio & Yonetani, "Client selection for FL with heterogeneous resources in
mobile edge", IEEE ICC 2019).

Filters stragglers: only clients whose estimated round completion fits the
deadline participate. The paper's critique — "the stragglers' contribution to
the training process is ignored, and thereby the learning accuracy may be
degraded" — is exactly what the FL co-simulation quantifies (fewer clients →
lower saturated accuracy, Fig 2a).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.slicing import ClientProfile


def estimated_completion(
    c: ClientProfile, uplink_bps: float
) -> float:
    """Optimistic per-client round estimate: Δ_i + dedicated-line upload."""
    return c.delta + c.m_ud_bits / uplink_bps + c.propagation_s


def select_by_deadline(
    clients: Sequence[ClientProfile],
    deadline_s: float,
    uplink_bps: float,
) -> Tuple[List[ClientProfile], List[ClientProfile]]:
    """Returns (selected, filtered_stragglers)."""
    selected, dropped = [], []
    for c in clients:
        (selected if estimated_completion(c, uplink_bps) <= deadline_s
         else dropped).append(c)
    return selected, dropped


def greedy_max_clients(
    clients: Sequence[ClientProfile],
    deadline_s: float,
    uplink_bps: float,
) -> List[ClientProfile]:
    """Nishio's greedy: pack as many clients as possible into the deadline
    when uploads are serialised on the shared uplink (FCFS order by Δ)."""
    order = sorted(clients, key=lambda c: c.delta)
    chosen: List[ClientProfile] = []
    cursor = 0.0
    for c in order:
        start = max(cursor, c.delta)
        end = start + c.m_ud_bits / uplink_bps + c.propagation_s
        if end <= deadline_s:
            chosen.append(c)
            cursor = start + c.m_ud_bits / uplink_bps
    return chosen
