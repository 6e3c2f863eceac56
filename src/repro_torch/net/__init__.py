"""PON network substrate on PyTorch: traffic, the DBAs, the batched round
engine, the multi-round timeline (fault injection included), multi-tenant
jobs and their sweep facade. Build a :class:`SweepSpec` (with a
:class:`TimelineSchedule` for a timeline) and run it with
:func:`simulate` (``device="cuda"`` by default). :func:`simulate_round`
runs one round on the engine or on the cycle-level simulator; the
``simulate_*_reference`` functions and :func:`simulate_multi_pon_round`
are the cycle-level oracles the engine is held to."""
from repro_torch.faults import FaultSchedule, RetryPolicy
from repro_torch.net.api import SweepSpec, simulate
from repro_torch.net.convert import from_reference
from repro_torch.net.dba import (
    DEFAULT_EFFICIENCY,
    FCFSBestEffort,
    FCFSLimitedService,
    OnuQueue,
    SlicedDBA,
)
from repro_torch.net.engine import SweepCase, simulate_round_sweep
from repro_torch.net.jobs import (
    FAIRNESS_POLICIES,
    JobRoundStats,
    JobSpec,
    job_fair_split,
    make_competing_jobs,
    simulate_jobs_round_reference,
)
from repro_torch.net.multi_pon import (
    MultiPonTopology,
    cps_waterfill,
    pon_bg_rates,
    simulate_multi_pon_round,
)
from repro_torch.net.sim import (
    FLRoundWorkload,
    PONConfig,
    RoundResult,
    simulate_round,
)
from repro_torch.net.timeline import (
    DEADLINE_POLICIES,
    TimelineResult,
    TimelineRound,
    TimelineSchedule,
    simulate_timeline_per_round,
    simulate_timeline_reference,
    simulate_timeline_sweep,
)
from repro_torch.net.traffic import (
    PACKET_BITS,
    CounterSource,
    CounterStream,
    PoissonSource,
    PrecomputedSource,
    background_rate_for_load,
    burst_lambda,
    counter_streams_for_pons,
    per_onu_sources,
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
    "simulate_jobs_round_reference",
    "MultiPonTopology",
    "cps_waterfill",
    "pon_bg_rates",
    "simulate_multi_pon_round",
    "simulate_round_sweep",
    "simulate_round",
    "DEADLINE_POLICIES",
    "TimelineSchedule",
    "TimelineRound",
    "TimelineResult",
    "simulate_timeline_sweep",
    "simulate_timeline_per_round",
    "simulate_timeline_reference",
    "FaultSchedule",
    "RetryPolicy",
    "from_reference",
    "DEFAULT_EFFICIENCY",
    "FCFSBestEffort",
    "FCFSLimitedService",
    "OnuQueue",
    "SlicedDBA",
    "PACKET_BITS",
    "CounterSource",
    "CounterStream",
    "PoissonSource",
    "PrecomputedSource",
    "background_rate_for_load",
    "burst_lambda",
    "counter_streams_for_pons",
    "per_onu_sources",
]
