"""Frozen sweep-spec facade over the round and timeline engines.

:class:`SweepSpec` carries the cases, the optional multi-round
``schedule`` and every sweep-level knob, validates the bundle once and
runs through :func:`simulate` on a device: the timeline when the
spec has a schedule, else the round engine. ``backend="jit"`` runs each
phase in one call (the fused phase kernel on a card; multi-job sweeps
run the per-cycle loop). A ``collector`` (``repro_torch.obs.Collector``)
instruments the per-cycle loop; ``backend="jit"`` refuses it::

    spec = SweepSpec.single_job(clients, model_bits=25e6,
                                load=0.6, policy="bs")
    spec = spec.with_schedule(TimelineSchedule(n_rounds=8))
    spec = spec.with_faults(FaultSchedule(dropout_rate=0.05))
    spec = spec.with_jobs(jobs, fairness="weighted")
    results = simulate(spec)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from repro_torch._device import DEFAULT_DEVICE
from repro_torch.net.engine import (
    _BACKENDS,
    SweepCase,
    _round_sweep,
    _sweep_topology,
)
from repro_torch.net.jobs import FAIRNESS_POLICIES, validate_case_jobs
from repro_torch.net.sim import FLRoundWorkload, PONConfig
from repro_torch.net.timeline import TimelineSchedule, _timeline_sweep

__all__ = ["SweepSpec", "simulate"]

_MODES = ("auto", "folded", "sequential")
_POLICIES = ("fcfs", "bs")


@dataclass(frozen=True)
class SweepSpec:
    """One immutable sweep: cases + schedule + knobs.

    ``pon`` is the :class:`PONConfig` (``None`` = the defaults, or the
    config passed to :func:`simulate`). ``schedule`` (a
    :class:`TimelineSchedule`) makes the spec a multi-round timeline;
    without it ``ul_deadline_s`` and ``ul_outage_s`` are the round's
    upload deadline and outage windows (see ``engine._round_sweep``).
    ``mode`` is the timeline's fold/sequential selector and stays
    ``"auto"`` for round sweeps. ``backend`` is ``None``/``"numpy"``
    (the per-cycle loop) or ``"jit"`` (each phase in one call).
    """

    cases: Tuple[SweepCase, ...] = field(default_factory=tuple)
    pon: Optional[PONConfig] = None
    schedule: Optional[TimelineSchedule] = None
    mode: str = "auto"
    t_round_hint: float = 10.0
    max_t: float = 600.0
    ul_deadline_s: Optional[object] = None
    ul_outage_s: Optional[object] = None
    backend: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "cases", tuple(self.cases))

    def validate(self) -> "SweepSpec":
        """Check the whole bundle; returns ``self`` for chaining."""
        if not self.cases:
            raise ValueError("SweepSpec needs at least one case")
        for b, case in enumerate(self.cases):
            if not isinstance(case, SweepCase):
                raise TypeError(
                    f"cases[{b}] must be a SweepCase; "
                    f"got {type(case).__name__}"
                )
            if case.policy not in _POLICIES:
                raise ValueError(
                    f"cases[{b}]: unknown policy {case.policy!r}; "
                    f"have {_POLICIES}"
                )
            if case.fairness not in FAIRNESS_POLICIES:
                raise ValueError(
                    f"cases[{b}]: unknown fairness {case.fairness!r}; "
                    f"have {FAIRNESS_POLICIES}"
                )
            if case.jobs is not None:
                try:
                    validate_case_jobs(case.jobs, case.workload)
                except ValueError as e:
                    raise ValueError(f"cases[{b}]: {e}") from None
        _sweep_topology(list(self.cases))
        if self.pon is not None and not isinstance(self.pon, PONConfig):
            raise TypeError("pon must be a repro_torch.net.PONConfig or "
                            "None")
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; have {_MODES}"
            )
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; have {_BACKENDS}"
            )
        if self.schedule is not None:
            if not isinstance(self.schedule, TimelineSchedule):
                raise TypeError(
                    "schedule must be a repro_torch.net.TimelineSchedule"
                )
            if (self.ul_deadline_s is not None
                    or self.ul_outage_s is not None):
                raise ValueError(
                    "timeline specs take deadlines and faults from "
                    "the schedule; ul_deadline_s/ul_outage_s are "
                    "single-round sweep knobs"
                )
        elif self.mode != "auto":
            raise ValueError(
                "mode is a timeline knob; a round sweep (no schedule) "
                "has no folded/sequential split"
            )
        return self

    @classmethod
    def single_job(cls, clients, model_bits: float, *, load: float,
                   policy: str = "bs", seed: int = 0,
                   t_aggregate: float = 0.0, topology=None,
                   pon: Optional[PONConfig] = None,
                   **kwargs) -> "SweepSpec":
        """A one-case, single-tenant spec from bare FL inputs."""
        wl = FLRoundWorkload(
            clients=list(clients), model_bits=float(model_bits),
            t_aggregate=float(t_aggregate),
        )
        case = SweepCase(workload=wl, load=float(load), policy=policy,
                         seed=int(seed), topology=topology)
        return cls(cases=(case,), pon=pon, **kwargs)

    def with_schedule(self, schedule: TimelineSchedule) -> "SweepSpec":
        """The same sweep as a multi-round timeline."""
        return replace(self, schedule=schedule)

    def with_faults(self, faults, retry=None) -> "SweepSpec":
        """Attach fault injection to the spec's schedule."""
        if self.schedule is None:
            raise ValueError(
                "with_faults needs a schedule; call "
                "with_schedule(TimelineSchedule(...)) first"
            )
        sched = replace(
            self.schedule, faults=faults,
            retry=retry if retry is not None else self.schedule.retry,
        )
        return replace(self, schedule=sched)

    def with_jobs(self, jobs, fairness: str = "maxmin") -> "SweepSpec":
        """Make every case multi-tenant with the same job tuple."""
        jobs = tuple(jobs)
        return replace(self, cases=tuple(
            replace(case, jobs=jobs, fairness=fairness)
            for case in self.cases
        ))


def simulate(spec: SweepSpec, cfg: Optional[PONConfig] = None,
             collector=None, *, device=DEFAULT_DEVICE):
    """Run a validated :class:`SweepSpec` on ``device``: a
    ``List[TimelineResult]`` when the spec has a ``schedule``, else a
    ``List[RoundResult]``. ``cfg`` overrides ``spec.pon``; with neither,
    the default :class:`PONConfig` runs. ``collector`` (a
    ``repro_torch.obs.Collector``, run-time state, so it rides outside
    the frozen spec) turns metrics on."""
    if not isinstance(spec, SweepSpec):
        raise TypeError(
            f"simulate takes a SweepSpec; got {type(spec).__name__}"
        )
    spec.validate()
    pon = cfg if cfg is not None else (
        spec.pon if spec.pon is not None else PONConfig()
    )
    cases = list(spec.cases)
    if spec.schedule is not None:
        return _timeline_sweep(
            pon, cases, spec.schedule, mode=spec.mode,
            t_round_hint=spec.t_round_hint, max_t=spec.max_t,
            collector=collector, backend=spec.backend, device=device,
        )
    return _round_sweep(
        pon, cases, t_round_hint=spec.t_round_hint, max_t=spec.max_t,
        ul_deadline_s=spec.ul_deadline_s, ul_outage_s=spec.ul_outage_s,
        collector=collector, backend=spec.backend, device=device,
    )
