"""Multi-round timeline over the batched round engine.

The port of ``repro.net.timeline``: R synchronisation rounds back to
back, with elastic client membership, per-round upload sizes and
deadlines, advanced through ``engine._round_sweep`` on a device (the
per-cycle loop, or one launch of the fused phase kernel a phase with
``backend="jit"``).

* **Folded** (no deadline, or the ``"drop"``/``"partial"`` policies:
  nothing crosses a round boundary): the round axis folds into the
  engine's batch axis, so all R rounds of all B cases run as one stacked
  simulation of R·B rows. The counter-based sampler keys round ``r``'s
  stream by ``(seed, phase, r, pon)``, so each row draws its own
  arrivals.
* **Sequential** (``deadline_policy="defer"``): a client still uploading
  at the deadline carries its unserved bits into the next round, where
  it skips the download and resumes with zero compute time; the engine
  advances round by round, batched over cases.
* **Async** (``buffer_k``, FedBuff): each round runs twice, a free pass
  that finds the ``buffer_k``-th completion ``t_k``, then a pass cut at
  ``t_k`` whose stragglers defer with staleness.

Deadline policies: ``"defer"`` (carry the unserved bits), ``"drop"``
(discard them; the client re-enters fresh) and ``"partial"`` (discard,
but report the served fraction as a usable partial update).

Not ported yet, and raising ``NotImplementedError`` (ROADMAP Queue 1
item 8): fault injection and retries (``TimelineSchedule.faults`` /
``retry``), multi-tenant ``SweepCase.jobs`` and a ``collector``. The
cycle-level oracle ``simulate_timeline_reference`` is item 9.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch._device import DEFAULT_DEVICE
from repro_torch.net.engine import SweepCase, _not_ported, _round_sweep
from repro_torch.net.sim import FLRoundWorkload, RoundResult

__all__ = [
    "DEADLINE_POLICIES",
    "TimelineSchedule",
    "TimelineRound",
    "TimelineResult",
    "simulate_timeline_sweep",
    "simulate_timeline_per_round",
]

DEADLINE_POLICIES = ("defer", "drop", "partial")


@dataclass(frozen=True)
class TimelineSchedule:
    """The multi-round structure shared by every case of a sweep.

    ``membership``: optional ``(n_rounds, n_clients)`` bool mask over each
    case's ``workload.clients`` list positions; a masked-out client takes
    no part in the round. Deferred carriers override the mask.
    ``m_ud_bits``: optional per-round upload size, ``(n_rounds,)`` or
    ``(n_rounds, n_clients)``. ``deadline_s``: optional round deadline,
    scalar or ``(n_rounds,)``, handled per ``deadline_policy``.
    ``buffer_k``: async mode, each round firing at the ``buffer_k``-th
    completed upload (no ``deadline_s``). ``quorum_frac``: a deadlined
    round commits only when ``ceil(quorum_frac * n_pending)`` uploads
    arrived, else its deadline doubles and it re-runs, up to
    ``quorum_max_extends`` times. ``faults`` and ``retry`` mirror the
    reference's fields; only ``None`` is ported.

    Array inputs are normalised and copied once, at construction.
    """

    n_rounds: int
    membership: Optional[np.ndarray] = None
    m_ud_bits: Optional[np.ndarray] = None
    deadline_s: Optional[object] = None
    deadline_policy: str = "defer"
    buffer_k: Optional[int] = None
    faults: Optional[object] = None
    retry: Optional[object] = None
    quorum_frac: Optional[float] = None
    quorum_max_extends: int = 2

    def __post_init__(self):
        if self.faults is not None or self.retry is not None:
            raise _not_ported("faults")
        if self.n_rounds < 1:
            raise ValueError("n_rounds must be >= 1")
        if self.deadline_policy not in DEADLINE_POLICIES:
            raise ValueError(
                f"unknown deadline_policy {self.deadline_policy!r}; "
                f"have {DEADLINE_POLICIES}"
            )
        if self.membership is not None:
            m = np.array(self.membership, dtype=bool)
            if m.ndim != 2 or m.shape[0] != self.n_rounds:
                raise ValueError(
                    f"membership must be (n_rounds, n_clients); "
                    f"got {m.shape}"
                )
            object.__setattr__(self, "membership", m)
        if self.deadline_s is not None:
            d = np.array(self.deadline_s, dtype=np.float64).reshape(-1)
            if d.size not in (1, self.n_rounds):
                raise ValueError(
                    f"deadline_s must be scalar or (n_rounds,); "
                    f"got {d.size} values for {self.n_rounds} rounds"
                )
            object.__setattr__(self, "deadline_s", d)
        elif self.deadline_policy != "defer":
            raise ValueError(
                f"deadline_policy={self.deadline_policy!r} needs "
                "deadline_s (without a deadline nothing is ever cut)"
            )
        if self.m_ud_bits is not None:
            m = np.array(self.m_ud_bits, dtype=np.float64)
            if m.shape[0] != self.n_rounds:
                raise ValueError(
                    f"m_ud_bits must lead with n_rounds="
                    f"{self.n_rounds}; got shape {m.shape}"
                )
            object.__setattr__(self, "m_ud_bits", m)
        if self.buffer_k is not None:
            if int(self.buffer_k) < 1:
                raise ValueError("buffer_k must be >= 1")
            if self.deadline_s is not None:
                raise ValueError(
                    "async mode (buffer_k) fires at the k-th arrival; "
                    "it cannot be combined with deadline_s"
                )
            object.__setattr__(self, "buffer_k", int(self.buffer_k))
        if self.quorum_frac is not None:
            q = float(self.quorum_frac)
            if not 0.0 < q <= 1.0:
                raise ValueError(
                    f"quorum_frac must be in (0, 1]; got {q}"
                )
            if self.buffer_k is not None:
                raise ValueError(
                    "async mode (buffer_k) is its own arrival quorum; "
                    "it cannot be combined with quorum_frac"
                )
            if self.deadline_s is None:
                raise ValueError(
                    "quorum_frac needs deadline_s: without a deadline "
                    "every pending upload always arrives"
                )
            object.__setattr__(self, "quorum_frac", q)
        if int(self.quorum_max_extends) < 0:
            raise ValueError("quorum_max_extends must be >= 0")
        object.__setattr__(
            self, "quorum_max_extends", int(self.quorum_max_extends)
        )

    @property
    def asynchronous(self) -> bool:
        return self.buffer_k is not None

    @property
    def couples_rounds(self) -> bool:
        """True when state crosses round boundaries (no folding)."""
        return (
            self.asynchronous
            or (self.deadline_s is not None
                and self.deadline_policy == "defer")
            or self.quorum_frac is not None
        )

    def deadline(self, r: int) -> Optional[float]:
        if self.deadline_s is None:
            return None
        d = self.deadline_s
        return float(d[r] if d.size > 1 else d[0])

    def round_m_ud(self, r: int, j: int, default: float) -> float:
        if self.m_ud_bits is None:
            return default
        m = self.m_ud_bits
        return float(m[r] if m.ndim == 1 else m[r, j])


@dataclass
class TimelineRound:
    """One round of one case's timeline."""

    round_index: int
    sync_time: float
    t_start: float
    t_end: float
    ul_bits: Dict[int, float]       # bits actually served this round
    arrived: List[int]              # clients whose update completed
    deferred: Dict[int, float]      # bits carried into the next round
    result: Optional[RoundResult]   # None for empty (no-client) rounds
    # rounds since each arrived client downloaded its model
    staleness: Dict[int, int] = field(default_factory=dict)
    # "drop": bits discarded at the deadline, by client
    dropped: Dict[int, float] = field(default_factory=dict)
    # "partial": served fraction of each client cut at the deadline
    partial: Dict[int, float] = field(default_factory=dict)
    # fault outcomes, kept for the reference's layout (always empty
    # until fault injection is ported)
    failed: Dict[int, float] = field(default_factory=dict)
    lost: List[int] = field(default_factory=list)
    retry_at: Dict[int, int] = field(default_factory=dict)
    gave_up: List[int] = field(default_factory=list)
    # quorum: whether the round met it (None: no quorum) and how often
    # its deadline doubled
    quorum_met: Optional[bool] = None
    deadline_extensions: int = 0
    job_sync: Dict[int, float] = field(default_factory=dict)


@dataclass
class TimelineResult:
    policy: str
    load: float
    seed: int
    rounds: List[TimelineRound]

    @property
    def sync_times(self) -> np.ndarray:
        return np.array([r.sync_time for r in self.rounds])

    @property
    def total_time_s(self) -> float:
        return float(self.sync_times.sum())


# ---------------------------------------------------------------------------
# per-round workloads
# ---------------------------------------------------------------------------


def _round_setup(case: SweepCase, schedule: TimelineSchedule, r: int,
                 carry: Dict[int, float]):
    """``(clients_r, no_dl_ids, rem_start)`` of round ``r``: fresh members
    take the round's upload size; carriers (deferred bits) re-enter with
    their remaining bits, zero compute time and no download, whatever
    the membership mask says."""
    clients = case.workload.clients
    mask = (schedule.membership[r] if schedule.membership is not None
            else np.ones(len(clients), bool))
    out = []
    rem_start: Dict[int, float] = {}
    for j, c in enumerate(clients):
        cid = c.client_id
        if cid in carry:
            bits = carry[cid]
            out.append(replace(c, t_ud=0.0, t_dl=0.0, m_ud_bits=bits))
            rem_start[cid] = bits
        elif mask[j]:
            bits = schedule.round_m_ud(r, j, c.m_ud_bits)
            out.append(replace(c, m_ud_bits=bits))
            rem_start[cid] = bits
    return out, frozenset(carry), rem_start


def _round_view(r: int, t_start: float, result: Optional[RoundResult],
                rem_start: Dict[int, float], t_aggregate: float,
                policy: str = "defer",
                entry: Optional[Dict[int, int]] = None):
    """``(TimelineRound, next carry)`` of one round's result. ``entry``
    maps each pending client to the round it downloaded its model;
    arrived clients report staleness ``r - entry``. A ``None`` result is
    legal only for a round with no pending client."""
    if result is None:
        if rem_start:
            raise RuntimeError(
                f"round {r} produced no simulation result but has "
                f"pending clients {sorted(rem_start)}: carriers must be "
                "routed into a non-empty round, not dropped"
            )
        rnd = TimelineRound(
            round_index=r, sync_time=t_aggregate, t_start=t_start,
            t_end=t_start + t_aggregate, ul_bits={}, arrived=[],
            deferred={}, result=None,
        )
        return rnd, {}
    remaining = dict(result.ul_remaining or {})
    ul_bits = {
        cid: rem_start[cid] - remaining.get(cid, 0.0)
        for cid in rem_start
    }
    arrived = sorted(cid for cid in rem_start if cid not in remaining)
    staleness = {
        cid: (r - entry.get(cid, r)) if entry is not None else 0
        for cid in arrived
    }
    deferred: Dict[int, float] = {}
    dropped: Dict[int, float] = {}
    partial: Dict[int, float] = {}
    if policy == "defer":
        deferred = remaining
    elif policy == "drop":
        dropped = remaining
    elif policy == "partial":
        partial = {cid: ul_bits[cid] / rem_start[cid] for cid in remaining}
    else:  # pragma: no cover - schedule validation rejects earlier
        raise ValueError(f"unknown deadline_policy {policy!r}")
    rnd = TimelineRound(
        round_index=r, sync_time=result.sync_time, t_start=t_start,
        t_end=t_start + result.sync_time, ul_bits=ul_bits,
        arrived=arrived, deferred=deferred, result=result,
        staleness=staleness, dropped=dropped, partial=partial,
    )
    return rnd, deferred


def _kth_completion(result: RoundResult, rem_start: Dict[int, float],
                    buffer_k: int) -> Optional[float]:
    """The async cutoff: the completion time of the ``buffer_k``-th
    pending upload (a zero-bit upload completes at the round start;
    fewer than k pending clients: the last completion). ``None`` when
    nothing is pending."""
    times = sorted(
        0.0 if np.isnan(result.ul_done[cid]) else float(result.ul_done[cid])
        for cid in rem_start
    )
    if not times:
        return None
    return times[min(buffer_k, len(times)) - 1]


def _validate(cases: Sequence[SweepCase], schedule: TimelineSchedule):
    cases = list(cases)
    if not cases:
        raise ValueError("timeline sweep needs at least one case")
    for case in cases:
        if case.dl_arrivals is not None or case.ul_arrivals is not None:
            raise ValueError(
                "timeline cases draw from counter streams; injected "
                "arrival matrices are a single-round parity hook"
            )
        if schedule.membership is not None and (
            schedule.membership.shape[1] != len(case.workload.clients)
        ):
            raise ValueError(
                "membership mask width must match workload.clients"
            )
    if any(case.jobs is not None for case in cases):
        raise _not_ported("jobs")
    return cases


# ---------------------------------------------------------------------------
# engine-backed modes
# ---------------------------------------------------------------------------


def _row_case(case: SweepCase, clients_r, r: int,
              no_dl: frozenset = frozenset()) -> SweepCase:
    wl = FLRoundWorkload(
        clients=clients_r, model_bits=case.workload.model_bits,
        t_aggregate=case.workload.t_aggregate,
    )
    return SweepCase(workload=wl, load=case.load, policy=case.policy,
                     seed=case.seed, stream_round=r, no_dl_ids=no_dl,
                     topology=case.topology)


def _build_rows(cases, schedule, r, carries):
    """Round ``r``'s engine rows and, per case, ``(b, row index or None,
    rem_start)``."""
    row_cases = []
    row_meta = []
    for b, case in enumerate(cases):
        clients_r, no_dl, rem_start = _round_setup(
            case, schedule, r, carries[b])
        if not clients_r:
            row_meta.append((b, None, rem_start))
            continue
        row_meta.append((b, len(row_cases), rem_start))
        row_cases.append(_row_case(case, clients_r, r, no_dl))
    return row_cases, row_meta


def _advance_rounds(cfg, cases, schedule, t_round_hint, max_t, policy,
                    deadline_fn, backend, device):
    """Advance round by round: build the rows, take each round's
    deadline(s) from ``deadline_fn(r, row_cases, row_meta)`` (a scalar or
    a per-row list), advance the engine, re-run rows short of their
    quorum with a doubled deadline, and carry deferred bits forward."""
    B = len(cases)
    carries: List[Dict[int, float]] = [{} for _ in range(B)]
    entries: List[Dict[int, int]] = [{} for _ in range(B)]
    t_now = [0.0] * B
    out = [TimelineResult(policy=c.policy, load=c.load, seed=c.seed,
                          rounds=[]) for c in cases]
    quorum = schedule.quorum_frac
    for r in range(schedule.n_rounds):
        row_cases, row_meta = _build_rows(cases, schedule, r, carries)
        for b, _, rem_start in row_meta:
            for cid in rem_start:
                entries[b].setdefault(cid, r)
        deadlines = deadline_fn(r, row_cases, row_meta)
        results = _round_sweep(
            cfg, row_cases, t_round_hint=t_round_hint, max_t=max_t,
            ul_deadline_s=deadlines, backend=backend, device=device,
        ) if row_cases else []
        ext_counts: Dict[int, int] = {}
        met: Dict[int, bool] = {}
        if quorum is not None and row_cases:
            dls = (list(deadlines)
                   if isinstance(deadlines, (list, tuple, np.ndarray))
                   else [deadlines] * len(row_cases))

            def _unmet():
                redo = []
                for b, ridx, rem_start in row_meta:
                    if ridx is None or dls[ridx] is None:
                        continue
                    remaining = results[ridx].ul_remaining or {}
                    got = sum(1 for cid in rem_start
                              if cid not in remaining)
                    need = max(1, math.ceil(quorum * len(rem_start)))
                    met[ridx] = got >= need
                    if got < need:
                        redo.append(ridx)
                return redo

            for _ in range(schedule.quorum_max_extends):
                redo = _unmet()
                if not redo:
                    break
                for ridx in redo:
                    dls[ridx] = float(dls[ridx]) * 2.0
                    ext_counts[ridx] = ext_counts.get(ridx, 0) + 1
                sub = _round_sweep(
                    cfg, [row_cases[i] for i in redo],
                    t_round_hint=t_round_hint, max_t=max_t,
                    ul_deadline_s=[dls[i] for i in redo],
                    backend=backend, device=device,
                )
                for j, ridx in enumerate(redo):
                    results[ridx] = sub[j]
            else:
                _unmet()        # the verdicts after the last extension
        for b, ridx, rem_start in row_meta:
            res = results[ridx] if ridx is not None else None
            rnd, carry = _round_view(
                r, t_now[b], res, rem_start,
                cases[b].workload.t_aggregate, policy, entries[b],
            )
            if ridx is not None and ridx in met:
                rnd.quorum_met = met[ridx]
                rnd.deadline_extensions = ext_counts.get(ridx, 0)
            out[b].rounds.append(rnd)
            carries[b] = carry
            entries[b] = {cid: ent for cid, ent in entries[b].items()
                          if cid in carry}
            t_now[b] += rnd.sync_time
    return out


def _sequential(cfg, cases, schedule, t_round_hint, max_t, backend,
                device):
    """Round by round, carrying deferred bits (the only legal order
    under defer deadlines)."""
    return _advance_rounds(
        cfg, cases, schedule, t_round_hint, max_t,
        schedule.deadline_policy,
        lambda r, row_cases, row_meta: schedule.deadline(r),
        backend, device,
    )


def _async(cfg, cases, schedule, t_round_hint, max_t, backend, device):
    """FedBuff rounds: a free pass finds each row's ``buffer_k``-th
    completion, then the round runs cut there; stragglers defer with
    staleness."""
    k = schedule.buffer_k

    def deadline_fn(r, row_cases, row_meta):
        free = _round_sweep(
            cfg, row_cases, t_round_hint=t_round_hint, max_t=max_t,
            backend=backend, device=device,
        )
        deadlines: List[Optional[float]] = [None] * len(row_cases)
        for _, ridx, rem_start in row_meta:
            if ridx is not None:
                deadlines[ridx] = _kth_completion(free[ridx], rem_start, k)
        return deadlines

    return _advance_rounds(
        cfg, cases, schedule, t_round_hint, max_t, "defer", deadline_fn,
        backend, device,
    )


def _folded(cfg, cases, schedule, t_round_hint, max_t, backend, device):
    """The whole timeline as one stacked simulation: the round axis
    folded into the engine's batch, each row under its own round's
    deadline."""
    rows = []
    row_deadlines: List[Optional[float]] = []
    meta = []            # (b, r, rem_start, row index or None)
    for b, case in enumerate(cases):
        for r in range(schedule.n_rounds):
            clients_r, _, rem_start = _round_setup(case, schedule, r, {})
            if not clients_r:
                meta.append((b, r, rem_start, None))
                continue
            meta.append((b, r, rem_start, len(rows)))
            rows.append(_row_case(case, clients_r, r))
            row_deadlines.append(schedule.deadline(r))
    has_deadline = schedule.deadline_s is not None
    results = _round_sweep(
        cfg, rows, t_round_hint=t_round_hint, max_t=max_t,
        ul_deadline_s=row_deadlines if has_deadline else None,
        backend=backend, device=device,
    ) if rows else []
    out = [TimelineResult(policy=c.policy, load=c.load, seed=c.seed,
                          rounds=[]) for c in cases]
    t_now = [0.0] * len(cases)
    for b, r, rem_start, ridx in meta:
        res = results[ridx] if ridx is not None else None
        rnd, _ = _round_view(
            r, t_now[b], res, rem_start,
            cases[b].workload.t_aggregate, schedule.deadline_policy,
        )
        out[b].rounds.append(rnd)
        t_now[b] += rnd.sync_time
    return out


def _timeline_sweep(cfg, cases: Sequence[SweepCase],
                    schedule: TimelineSchedule,
                    mode: str = "auto",
                    t_round_hint: float = 10.0,
                    max_t: float = 600.0,
                    collector=None,
                    backend: Optional[str] = None,
                    *, device=DEFAULT_DEVICE) -> List[TimelineResult]:
    """Advance the full multi-round timeline of every case on ``device``.

    ``mode="auto"`` folds the round axis into the batch when nothing
    couples consecutive rounds and runs round by round otherwise;
    ``schedule.buffer_k`` selects async rounds; ``"folded"`` and
    ``"sequential"`` force a path. ``backend`` reaches every engine call.
    """
    if collector is not None:
        raise _not_ported("collector")
    cases = _validate(cases, schedule)
    run = (cfg, cases, schedule, t_round_hint, max_t, backend, device)
    if schedule.asynchronous:
        if mode == "folded":
            raise ValueError(
                "async rounds couple consecutive rounds (stragglers "
                "defer); folded mode is unavailable"
            )
        return _async(*run)
    if mode == "auto":
        mode = "sequential" if schedule.couples_rounds else "folded"
    if mode == "folded":
        if schedule.couples_rounds:
            raise ValueError(
                "schedule couples consecutive rounds (deadline "
                "deferral or quorum extension); folded mode requires "
                "independent rounds: no deadline, or drop/partial "
                "policies"
            )
        return _folded(*run)
    if mode == "sequential":
        return _sequential(*run)
    raise ValueError(f"unknown mode {mode!r}")


def simulate_timeline_sweep(cfg, cases=None, schedule=None,
                            mode: str = "auto",
                            t_round_hint: float = 10.0,
                            max_t: float = 600.0,
                            collector=None,
                            backend: Optional[str] = None,
                            *, device=DEFAULT_DEVICE,
                            ) -> List[TimelineResult]:
    """Advance the full multi-round timeline of every case.

    Preferred form: a :class:`repro_torch.net.SweepSpec` with a
    ``schedule`` as the sole argument (or after a ``PONConfig``). The
    legacy ``(cfg, cases, schedule, **kwargs)`` form works and emits a
    ``DeprecationWarning``; both give identical results.
    """
    from repro_torch.net.api import SweepSpec, simulate

    spec = None
    pon = None
    if isinstance(cfg, SweepSpec):
        if cases is not None or schedule is not None:
            raise TypeError(
                "pass either a SweepSpec or (cfg, cases, schedule), "
                "not both"
            )
        spec = cfg
    elif isinstance(cases, SweepSpec):
        if schedule is not None:
            raise TypeError(
                "pass the schedule inside the SweepSpec, not as a "
                "third argument"
            )
        spec, pon = cases, cfg
    if spec is not None:
        if spec.schedule is None:
            raise ValueError(
                "simulate_timeline_sweep needs a spec with a "
                "schedule; use simulate(spec) or "
                "simulate_round_sweep(spec) for single-round sweeps"
            )
        if mode != "auto" and mode != spec.mode:
            spec = replace(spec, mode=mode)
        return simulate(spec, pon, collector=collector, device=device)
    warnings.warn(
        "simulate_timeline_sweep(cfg, cases, schedule, **kwargs) is "
        "deprecated; build a repro_torch.net.SweepSpec (with .schedule) "
        "and call simulate(spec)",
        DeprecationWarning, stacklevel=2,
    )
    return _timeline_sweep(cfg, cases, schedule, mode=mode,
                           t_round_hint=t_round_hint, max_t=max_t,
                           collector=collector, backend=backend,
                           device=device)


def simulate_timeline_per_round(cfg, cases: Sequence[SweepCase],
                                schedule: TimelineSchedule,
                                t_round_hint: float = 10.0,
                                max_t: float = 600.0,
                                collector=None,
                                backend: Optional[str] = None,
                                *, device=DEFAULT_DEVICE,
                                ) -> List[TimelineResult]:
    """One engine call a round (the baseline the folded run is measured
    against); async schedules run their two passes a round. Results
    equal :func:`simulate_timeline_sweep`'s."""
    if collector is not None:
        raise _not_ported("collector")
    cases = _validate(cases, schedule)
    run = (cfg, cases, schedule, t_round_hint, max_t, backend, device)
    return _async(*run) if schedule.asynchronous else _sequential(*run)
