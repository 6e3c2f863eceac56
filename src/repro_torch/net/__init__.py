"""PON network substrate on PyTorch: traffic, the batched round engine,
the multi-round timeline (fault injection included), multi-tenant jobs
and their sweep facade. Build a :class:`SweepSpec` (with a
:class:`TimelineSchedule` for a timeline) and run it with
:func:`simulate` (``device="cuda"`` by default)."""
from repro_torch.faults import FaultSchedule, RetryPolicy
from repro_torch.net.api import SweepSpec, simulate
from repro_torch.net.convert import from_reference
from repro_torch.net.engine import SweepCase, simulate_round_sweep
from repro_torch.net.jobs import (
    FAIRNESS_POLICIES,
    JobRoundStats,
    JobSpec,
    job_fair_split,
    make_competing_jobs,
)
from repro_torch.net.multi_pon import (
    MultiPonTopology,
    cps_waterfill,
    pon_bg_rates,
)
from repro_torch.net.sim import FLRoundWorkload, PONConfig, RoundResult
from repro_torch.net.timeline import (
    DEADLINE_POLICIES,
    TimelineResult,
    TimelineRound,
    TimelineSchedule,
    simulate_timeline_per_round,
    simulate_timeline_sweep,
)
from repro_torch.net.traffic import (
    PACKET_BITS,
    CounterStream,
    background_rate_for_load,
    burst_lambda,
)

__all__ = [
    "SweepSpec",
    "simulate",
    "SweepCase",
    "PONConfig",
    "FLRoundWorkload",
    "RoundResult",
    "FAIRNESS_POLICIES",
    "JobSpec",
    "JobRoundStats",
    "job_fair_split",
    "make_competing_jobs",
    "MultiPonTopology",
    "cps_waterfill",
    "pon_bg_rates",
    "simulate_round_sweep",
    "DEADLINE_POLICIES",
    "TimelineSchedule",
    "TimelineRound",
    "TimelineResult",
    "simulate_timeline_sweep",
    "simulate_timeline_per_round",
    "FaultSchedule",
    "RetryPolicy",
    "from_reference",
    "PACKET_BITS",
    "CounterStream",
    "background_rate_for_load",
    "burst_lambda",
]
