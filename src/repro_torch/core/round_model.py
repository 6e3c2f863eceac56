"""Synchronisation-round time model (paper §2, Fig. 1), host Python.

The port's own copy of ``repro.core.round_model``. A client's round is
``T_i^DL + T_i^UD + T_i^UL + T_a``; the round's synchronisation time is
``max_i (T_i^DL + T_i^UD) + upload drain``. :func:`bs_round_time` is the
analytic value under bandwidth slicing; the FCFS value comes from the
round engine (``repro_torch.net``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.scheduler import schedule_makespan, schedule_slots
from repro_torch.core.slicing import (
    LIGHT_SPEED_FIBER,
    ClientProfile,
    SliceSpec,
    compute_slice,
)


@dataclass(frozen=True)
class RoundTiming:
    sync_time: float            # wall-clock for the full round
    compute_bound: float        # max_i (T_i^DL + T_i^UD): the floor
    comm_overhead: float        # sync_time - compute_bound
    per_client_upload_end: dict


def bs_round_time(
    clients: Sequence[ClientProfile],
    capacity_bps: float,
    t_aggregate: float = 0.0,
    spec: SliceSpec | None = None,
) -> RoundTiming:
    """Analytic round time under bandwidth slicing, the round starting
    at t = 0 (the slice's times are relative to it)."""
    if spec is None:
        spec = compute_slice(clients, t_current=0.0, t_round=0.0,
                             capacity_bps=capacity_bps, h=1)
    slots = schedule_slots(clients, spec, round_start=0.0)
    makespan = schedule_makespan(slots)
    compute_bound = max(c.delta for c in clients)
    prop = max(c.propagation_s for c in clients)
    sync = makespan + prop + t_aggregate
    return RoundTiming(
        sync_time=sync,
        compute_bound=compute_bound,
        comm_overhead=sync - compute_bound,
        per_client_upload_end={s.client_id: s.t_end for s in slots},
    )


def download_time(model_bits: float, downlink_bps: float,
                  distance_m: float = 20_000.0) -> float:
    """``T_i^DL``: the global model's broadcast on reserved downlink."""
    return model_bits / downlink_bps + distance_m / LIGHT_SPEED_FIBER


def heterogeneous_compute_times(
    n_clients: int,
    rng,
    t_min_s: float = 1.0,
    t_max_s: float = 5.0,
) -> list:
    """Paper Fig. 2b: ``T_i^UD`` uniform in [1, 5] s across the EC nodes,
    drawn from the numpy generator ``rng``."""
    return list(rng.uniform(t_min_s, t_max_s, size=n_clients))
