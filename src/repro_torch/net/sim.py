"""PON round types: the network, the FL round's inputs and its result.

Topology (paper §3): one OLT/CPS and ``n_onus`` ONU/EC nodes, 10 Gbps
symmetric, 20 km reach, 1 ms polling cycle, ~92% payload efficiency.
The round's synchronisation time is ``max_i upload_done_i + T_a``.
The cycle-level oracle of the JAX package (``simulate_round`` with its
reference backend) is not ported; the port's engine is
``repro_torch.net.engine``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.slicing import (
    LIGHT_SPEED_FIBER,
    ClientProfile,
    SliceSpec,
)

EPS_BITS = 1.0                   # a client is done below 1 remaining bit
DEFAULT_EFFICIENCY = 0.92        # payload share after guard/REPORT/FEC


@dataclass(frozen=True)
class PONConfig:
    n_onus: int = 128
    line_rate_bps: float = 10e9      # symmetric up/down (paper §3)
    distance_m: float = 20_000.0
    cycle_time_s: float = 1e-3
    efficiency: float = DEFAULT_EFFICIENCY
    bg_burst_packets: float = 16.0

    @property
    def propagation_s(self) -> float:
        return self.distance_m / LIGHT_SPEED_FIBER


@dataclass
class RoundResult:
    policy: str
    sync_time: float
    dl_done: Dict[int, float]
    ready: Dict[int, float]
    ul_done: Dict[int, float]
    compute_bound: float
    load: float
    slice_spec: Optional[SliceSpec] = None
    # under an upload deadline: bits still queued per client at the
    # cutoff (their ul_done is NaN)
    ul_remaining: Optional[Dict[int, float]] = None
    # multi-tenant cases: job_id -> its hierarchical aggregation times
    # (net.jobs.JobRoundStats); None for single-tenant cases
    job_stats: Optional[Dict[int, "JobRoundStats"]] = None  # noqa: F821

    @property
    def comm_overhead(self) -> float:
        return self.sync_time - self.compute_bound


@dataclass
class FLRoundWorkload:
    """One round's FL inputs: involved clients with their compute times."""

    clients: List[ClientProfile]
    model_bits: float                # global model size (downlink)
    t_aggregate: float = 0.0
