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

Fault injection (``TimelineSchedule.faults``, ``repro_torch.faults``):
dropout truncates a victim's upload before the round (the engine, and
the phase kernel on jit, see an ordinary smaller update), outages reach
the engine as per-row ``[start, end)`` windows that darken a PON's
capacity, and payload loss is drawn for every pending client. Failed
uploads re-send under ``retry`` with backoff, or give up; quorum counts
only un-faulted arrivals. Dropout and loss couple rounds (the drivers
go round by round); outage-only schedules still fold.

Multi-tenant cases (``SweepCase.jobs``) always fold: each round keeps
the jobs active under their cadence (``JobSpec.period``/``phase``) and
reports each job's sync in ``TimelineRound.job_sync``.

A ``collector`` (``repro_torch.obs.Collector``) records, beside the
engine's phase metrics, each round (``record_round``), the staleness of
arrived updates, the deadline slack of clients that made the cut, the
fault events (``fault.dropout``, ``fault.loss``, ``fault.gave_up``) and
quorum extensions (``quorum.extend``), with a span a round
(``timeline:round[r]``) or a fold (``timeline:folded``,
``timeline:folded-jobs``); an async round's probe pass and quorum
re-runs stay uninstrumented, as in the reference.

:func:`simulate_timeline_reference` is the oracle the engine-backed
modes are held to: the same rounds, one at a time, on the cycle-level
simulator (``net.sim``, ``net.multi_pon``) fed the engine's counter
streams.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field, replace
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.faults import FaultSchedule, RetryPolicy
from repro_torch.net.engine import SweepCase, _round_sweep
from repro_torch.net.sim import FLRoundWorkload, RoundResult
from repro_torch.obs.trace import maybe_span

__all__ = [
    "DEADLINE_POLICIES",
    "TimelineSchedule",
    "TimelineRound",
    "TimelineResult",
    "simulate_timeline_sweep",
    "simulate_timeline_per_round",
    "simulate_timeline_reference",
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
    ``quorum_max_extends`` times; only un-faulted arrivals count.
    ``faults`` (a :class:`repro_torch.faults.FaultSchedule`): client
    dropout, upstream outage windows and payload loss from
    counter-based streams. A failed upload re-sends under ``retry``
    (:class:`repro_torch.faults.RetryPolicy`, ``RetryPolicy()`` by
    default): the client backs off ``delay_rounds(attempt)`` rounds,
    during which the membership mask cannot re-admit it, then re-enters
    like a carrier (no download, zero compute, its pending bits); past
    ``max_retries`` it gives up and re-enters fresh. A ``trivial``
    schedule is bitwise ``faults=None``.

    Array inputs are normalised and copied once, at construction.
    """

    n_rounds: int
    membership: Optional[np.ndarray] = None
    m_ud_bits: Optional[np.ndarray] = None
    deadline_s: Optional[object] = None
    deadline_policy: str = "defer"
    buffer_k: Optional[int] = None
    faults: Optional[FaultSchedule] = None
    retry: Optional[RetryPolicy] = None
    quorum_frac: Optional[float] = None
    quorum_max_extends: int = 2

    def __post_init__(self):
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
        if self.faults is not None and not isinstance(
            self.faults, FaultSchedule
        ):
            raise TypeError(
                "faults must be a repro_torch.faults.FaultSchedule")
        if self.retry is not None and not isinstance(
            self.retry, RetryPolicy
        ):
            raise TypeError("retry must be a repro_torch.faults.RetryPolicy")
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
    def active_faults(self) -> Optional[FaultSchedule]:
        """The fault schedule, or None when absent or trivial: every
        fault branch gates on this, which makes a trivial
        ``FaultSchedule()`` bitwise ``faults=None``."""
        f = self.faults
        return None if f is None or f.trivial else f

    @property
    def retry_policy(self) -> RetryPolicy:
        return self.retry if self.retry is not None else RetryPolicy()

    @property
    def couples_rounds(self) -> bool:
        """True when state crosses round boundaries (no folding)."""
        faults = self.active_faults
        return (
            self.asynchronous
            or (self.deadline_s is not None
                and self.deadline_policy == "defer")
            or (faults is not None and faults.couples_rounds)
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
    # fault outcomes: clients that died mid-upload (the bits they served
    # first, wasted wire time) and completed uploads that arrived
    # corrupted
    failed: Dict[int, float] = field(default_factory=dict)
    lost: List[int] = field(default_factory=list)
    # failed clients' re-send round, and the clients that gave up
    retry_at: Dict[int, int] = field(default_factory=dict)
    gave_up: List[int] = field(default_factory=list)
    # quorum: whether the round met it (None: no quorum) and how often
    # its deadline doubled
    quorum_met: Optional[bool] = None
    deadline_extensions: int = 0
    # multi-tenant cases: job_id -> the job's sync this round (empty for
    # single-tenant rounds and for jobs idle under their cadence)
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


class _RetryEntry(NamedTuple):
    """An in-flight re-send: the round it is due, its bits, the attempt."""

    due_round: int
    bits: float
    attempt: int


class _FaultState:
    """A case's fault bookkeeping, carried across rounds."""

    __slots__ = ("retries", "attempts")

    def __init__(self):
        # in-flight re-sends: client -> _RetryEntry
        self.retries: Dict[int, _RetryEntry] = {}
        # consecutive failed attempts a client (cleared by a clean
        # arrival or by giving up)
        self.attempts: Dict[int, int] = {}


_MIN_FAULT_BITS = 2.0   # dropout truncation floor (no 0-bit uploads)


def _round_setup(case: SweepCase, schedule: TimelineSchedule, r: int,
                 carry: Dict[int, float],
                 retries: Optional[Dict[int, _RetryEntry]] = None):
    """``(clients_r, no_dl_ids, rem_start, drops)`` of round ``r``.

    Fresh members take the round's upload size; carriers (deferred bits)
    re-enter with their remaining bits, zero compute time and no
    download, whatever the membership mask says. A due retry
    (``due_round <= r``) re-enters as a carrier does; one still backing
    off keeps the client out, mask or not. ``drops`` maps the round's
    dropout victims to their full pending bits: their upload here is cut
    at the death point (``_MIN_FAULT_BITS`` at least), and the retry
    re-sends the full payload.
    """
    clients = case.workload.clients
    mask = (schedule.membership[r] if schedule.membership is not None
            else np.ones(len(clients), bool))
    retries = retries or {}
    out = []
    rem_start: Dict[int, float] = {}
    no_dl = set(carry)
    for j, c in enumerate(clients):
        cid = c.client_id
        if cid in carry:
            if cid in retries:       # pragma: no cover - internal guard
                raise RuntimeError(
                    f"client {cid} is both a deferred carrier and an "
                    "in-flight retry at round "
                    f"{r}: fault bookkeeping desynced"
                )
            bits = carry[cid]
            out.append(replace(c, t_ud=0.0, t_dl=0.0, m_ud_bits=bits))
            rem_start[cid] = bits
        elif cid in retries:
            ent = retries[cid]
            if ent.due_round > r:
                continue             # backing off: the mask never revives
            retries.pop(cid)         # in flight again from this round
            out.append(replace(c, t_ud=0.0, t_dl=0.0,
                               m_ud_bits=ent.bits))
            rem_start[cid] = ent.bits
            no_dl.add(cid)
        elif mask[j]:
            bits = schedule.round_m_ud(r, j, c.m_ud_bits)
            out.append(replace(c, m_ud_bits=bits))
            rem_start[cid] = bits
    drops: Dict[int, float] = {}
    faults = schedule.active_faults
    if faults is not None and faults.dropout_rate > 0.0 and rem_start:
        frac = faults.dropouts(r, sorted(rem_start), case.seed)
        if frac:
            for i, c in enumerate(out):
                f = frac.get(c.client_id)
                if f is None:
                    continue
                full = c.m_ud_bits
                cut = min(max(f * full, _MIN_FAULT_BITS), full)
                out[i] = replace(c, m_ud_bits=cut)
                rem_start[c.client_id] = cut
                drops[c.client_id] = full
    return out, frozenset(no_dl), rem_start, drops


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


def _observe_round(collector, case, rnd: TimelineRound,
                   deadline: Optional[float]) -> None:
    """Fold one round into ``collector``: its wall time and outcome
    counts (``record_round``), the staleness of arrived updates and the
    deadline slack (deadline minus completion) of the clients that made
    the cut. Reads only; ``None`` does nothing."""
    if collector is None:
        return
    if rnd.staleness:
        collector.record_staleness(list(rnd.staleness.values()))
    if deadline is not None and rnd.result is not None and rnd.arrived:
        slack = [deadline - rnd.result.ul_done.get(cid, np.nan)
                 for cid in rnd.arrived]
        collector.record_slack(case.policy, case.load, slack)
    collector.record_round(
        policy=case.policy, load=case.load, seed=case.seed,
        round=rnd.round_index, sync_time=rnd.sync_time,
        t_start=rnd.t_start, t_end=rnd.t_end,
        ul_bits=float(sum(rnd.ul_bits.values())),
        n_arrived=len(rnd.arrived), n_deferred=len(rnd.deferred),
        n_dropped=len(rnd.dropped), n_partial=len(rnd.partial),
    )


def _round_faulted(schedule: TimelineSchedule, case, r: int,
                   rem_start: Dict[int, float],
                   drops: Dict[int, float]) -> frozenset:
    """The round's faulted clients: dropout victims and the loss draw.
    The loss draw covers every pending client, so the set is a function
    of ``(round, pending)`` alone: the same for a quorum re-run and the
    async probe pass."""
    faults = schedule.active_faults
    lost = (faults.losses(r, sorted(rem_start), case.seed)
            if faults is not None and faults.loss_rate > 0.0 and rem_start
            else frozenset())
    return frozenset(drops) | lost


def _effective_arrived(result: RoundResult, rem_start: Dict[int, float],
                       faulted: frozenset) -> List[int]:
    """Uploads that completed and were not cancelled by a fault: the
    arrivals a quorum counts."""
    remaining = result.ul_remaining or {}
    return [cid for cid in rem_start
            if cid not in remaining and cid not in faulted]


def _apply_round_faults(schedule: TimelineSchedule, case, r: int,
                        rnd: TimelineRound, rem_start: Dict[int, float],
                        carry: Dict[int, float], drops: Dict[int, float],
                        fstate: _FaultState,
                        collector=None) -> Dict[int, float]:
    """Cancel the round's faulted arrivals, book retries with backoff and
    return the updated carry.

    A dropout victim fails whatever the deadline policy (its served bits
    were wasted, ``rnd.failed``) and its retry re-sends the full
    payload. A loss victim crossed the wire but its payload is discarded
    (``rnd.lost``); its retry re-sends the round's pending bits. Either
    way the client backs off ``retry.delay_rounds(attempt)`` rounds
    (``rnd.retry_at``) or, past ``max_retries`` attempts, gives the
    update up (``rnd.gave_up``) and re-enters fresh. ``collector`` gets a
    ``fault.dropout``, ``fault.loss`` or ``fault.gave_up`` event for each.
    """
    faults = schedule.active_faults
    if faults is None:
        return carry
    retry = schedule.retry_policy

    def book(cid: int, bits: float):
        attempt = fstate.attempts.get(cid, 0) + 1
        if attempt > retry.max_retries:
            fstate.attempts.pop(cid, None)
            rnd.gave_up.append(cid)
            if collector is not None:
                collector.event("fault.gave_up", round=r, client=cid,
                                attempts=attempt - 1, seed=case.seed)
            return
        fstate.attempts[cid] = attempt
        due = r + retry.delay_rounds(attempt)
        fstate.retries[cid] = _RetryEntry(due, bits, attempt)
        rnd.retry_at[cid] = due

    for cid in sorted(drops):
        rnd.failed[cid] = rnd.ul_bits.get(cid, 0.0)
        if cid in rnd.arrived:
            rnd.arrived.remove(cid)
        rnd.staleness.pop(cid, None)
        carry.pop(cid, None)
        rnd.deferred.pop(cid, None)
        rnd.dropped.pop(cid, None)
        rnd.partial.pop(cid, None)
        book(cid, drops[cid])
        if collector is not None:
            collector.event("fault.dropout", round=r, client=cid,
                            wasted_bits=rnd.failed[cid], seed=case.seed)
    if faults.loss_rate > 0.0 and rnd.arrived:
        lost_draw = faults.losses(r, sorted(rem_start), case.seed)
        for cid in [c for c in rnd.arrived if c in lost_draw]:
            rnd.arrived.remove(cid)
            rnd.staleness.pop(cid, None)
            rnd.lost.append(cid)
            book(cid, rem_start[cid])
            if collector is not None:
                collector.event("fault.loss", round=r, client=cid,
                                bits=rem_start[cid], seed=case.seed)
    for cid in rnd.arrived:          # a clean arrival resets the backoff
        fstate.attempts.pop(cid, None)
    return carry


def _kth_completion(result: RoundResult, rem_start: Dict[int, float],
                    buffer_k: int,
                    exclude: frozenset = frozenset()) -> Optional[float]:
    """The async cutoff: the completion time of the ``buffer_k``-th
    pending upload (a zero-bit upload completes at the round start;
    fewer than k pending clients: the last completion). The round's
    faulted clients (``exclude``) never count toward the buffer.
    ``None`` when nothing valid is pending (the round runs free)."""
    times = sorted(
        0.0 if np.isnan(result.ul_done[cid]) else float(result.ul_done[cid])
        for cid in rem_start if cid not in exclude
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


def _case_n_pons(case) -> int:
    return case.topology.n_pons if case.topology is not None else 1


def _build_rows(cases, schedule, r, carries, fstates=None):
    """Round ``r``'s engine rows and, per case, ``(b, row index or None,
    rem_start, drops)``; ``fstates`` (each case's ``_FaultState``)
    supplies the retries due this round."""
    row_cases = []
    row_meta = []
    for b, case in enumerate(cases):
        clients_r, no_dl, rem_start, drops = _round_setup(
            case, schedule, r, carries[b],
            fstates[b].retries if fstates is not None else None)
        if not clients_r:
            row_meta.append((b, None, rem_start, drops))
            continue
        row_meta.append((b, len(row_cases), rem_start, drops))
        row_cases.append(_row_case(case, clients_r, r, no_dl))
    return row_cases, row_meta


def _round_outages(cases, schedule, r, row_meta):
    """Round ``r``'s outage windows, one a row of ``row_meta``'s rows, or
    None when no outage is drawn."""
    faults = schedule.active_faults
    if faults is None or faults.outage_rate <= 0.0:
        return None
    n_rows = sum(1 for _, ridx, _, _ in row_meta if ridx is not None)
    outages: List[Optional[np.ndarray]] = [None] * n_rows
    for b, ridx, _, _ in row_meta:
        if ridx is not None:
            outages[ridx] = faults.outage_windows(
                r, _case_n_pons(cases[b]), cases[b].seed)
    return outages


def _advance_rounds(cfg, cases, schedule, t_round_hint, max_t, policy,
                    deadline_fn, backend, device, collector=None):
    """Advance round by round: build the rows, take each round's
    deadline(s) from ``deadline_fn(r, row_cases, row_meta, outages)`` (a
    scalar or a per-row list), advance the engine, re-run the rows short
    of their quorum of un-faulted arrivals with a doubled deadline, then
    apply the round's faults and carry deferred bits and retries
    forward. Only the first pass of a round feeds ``collector``'s phase
    metrics; each quorum extension is a ``quorum.extend`` event."""
    B = len(cases)
    carries: List[Dict[int, float]] = [{} for _ in range(B)]
    entries: List[Dict[int, int]] = [{} for _ in range(B)]
    fstates = [_FaultState() for _ in range(B)]
    t_now = [0.0] * B
    out = [TimelineResult(policy=c.policy, load=c.load, seed=c.seed,
                          rounds=[]) for c in cases]
    quorum = schedule.quorum_frac
    for r in range(schedule.n_rounds):
        row_cases, row_meta = _build_rows(cases, schedule, r, carries,
                                          fstates)
        for b, _, rem_start, _ in row_meta:
            for cid in rem_start:
                entries[b].setdefault(cid, r)
        outages = _round_outages(cases, schedule, r, row_meta)
        deadlines = deadline_fn(r, row_cases, row_meta, outages)
        with maybe_span(collector, f"timeline:round[{r}]",
                        rows=len(row_cases)):
            results = _round_sweep(
                cfg, row_cases, t_round_hint=t_round_hint, max_t=max_t,
                ul_deadline_s=deadlines, ul_outage_s=outages,
                collector=collector, backend=backend, device=device,
            ) if row_cases else []
        ext_counts: Dict[int, int] = {}
        met: Dict[int, bool] = {}
        if quorum is not None and row_cases:
            dls = (list(deadlines)
                   if isinstance(deadlines, (list, tuple, np.ndarray))
                   else [deadlines] * len(row_cases))

            def _unmet():
                redo = []
                for b, ridx, rem_start, drops in row_meta:
                    if ridx is None or dls[ridx] is None:
                        continue
                    faulted = _round_faulted(schedule, cases[b], r,
                                             rem_start, drops)
                    got = len(_effective_arrived(results[ridx], rem_start,
                                                 faulted))
                    need = max(1, math.ceil(quorum * len(rem_start)))
                    met[ridx] = got >= need
                    if got < need:
                        redo.append((b, ridx))
                return redo

            for _ in range(schedule.quorum_max_extends):
                redo = _unmet()
                if not redo:
                    break
                for b, ridx in redo:
                    dls[ridx] = float(dls[ridx]) * 2.0
                    ext_counts[ridx] = ext_counts.get(ridx, 0) + 1
                    if collector is not None:
                        collector.event(
                            "quorum.extend", round=r, seed=cases[b].seed,
                            deadline_s=dls[ridx],
                            extension=ext_counts[ridx])
                redo = [ridx for _, ridx in redo]
                sub = _round_sweep(
                    cfg, [row_cases[i] for i in redo],
                    t_round_hint=t_round_hint, max_t=max_t,
                    ul_deadline_s=[dls[i] for i in redo],
                    ul_outage_s=(None if outages is None else
                                 [outages[i] for i in redo]),
                    backend=backend, device=device,
                )
                for j, ridx in enumerate(redo):
                    results[ridx] = sub[j]
            else:
                _unmet()        # the verdicts after the last extension
            deadlines = dls
        per_row_dl = isinstance(deadlines, (list, tuple, np.ndarray))
        for b, ridx, rem_start, drops in row_meta:
            res = results[ridx] if ridx is not None else None
            rnd, carry = _round_view(
                r, t_now[b], res, rem_start,
                cases[b].workload.t_aggregate, policy, entries[b],
            )
            if ridx is not None and ridx in met:
                rnd.quorum_met = met[ridx]
                rnd.deadline_extensions = ext_counts.get(ridx, 0)
            carry = _apply_round_faults(schedule, cases[b], r, rnd,
                                        rem_start, carry, drops, fstates[b],
                                        collector)
            out[b].rounds.append(rnd)
            carries[b] = carry
            entries[b] = {cid: ent for cid, ent in entries[b].items()
                          if cid in carry or cid in fstates[b].retries}
            t_now[b] += rnd.sync_time
            if collector is not None:
                dl = (deadlines[ridx]
                      if per_row_dl and ridx is not None else
                      None if per_row_dl else deadlines)
                _observe_round(collector, cases[b], rnd, dl)
    return out


def _sequential(cfg, cases, schedule, t_round_hint, max_t, backend,
                device, collector=None):
    """Round by round, carrying deferred bits and retries (the only legal
    order under defer deadlines, dropout or loss)."""
    return _advance_rounds(
        cfg, cases, schedule, t_round_hint, max_t,
        schedule.deadline_policy,
        lambda r, row_cases, row_meta, outages: schedule.deadline(r),
        backend, device, collector,
    )


def _async(cfg, cases, schedule, t_round_hint, max_t, backend, device,
           collector=None):
    """FedBuff rounds: a free pass finds each row's ``buffer_k``-th
    completion among its un-faulted uploads, then the round runs cut
    there; stragglers defer with staleness."""
    k = schedule.buffer_k

    def deadline_fn(r, row_cases, row_meta, outages):
        # the free pass is a search, not a round: only the deadline pass
        # feeds the collector, so nothing is counted twice
        free = _round_sweep(
            cfg, row_cases, t_round_hint=t_round_hint, max_t=max_t,
            ul_outage_s=outages, backend=backend, device=device,
        )
        deadlines: List[Optional[float]] = [None] * len(row_cases)
        for b, ridx, rem_start, drops in row_meta:
            if ridx is not None:
                deadlines[ridx] = _kth_completion(
                    free[ridx], rem_start, k,
                    _round_faulted(schedule, cases[b], r, rem_start,
                                   drops))
        return deadlines

    return _advance_rounds(
        cfg, cases, schedule, t_round_hint, max_t, "defer", deadline_fn,
        backend, device, collector,
    )


def _folded(cfg, cases, schedule, t_round_hint, max_t, backend, device,
            collector=None):
    """The whole timeline as one stacked simulation: the round axis
    folded into the engine's batch, each row under its own round's
    deadline and, with outage faults, its own round's outage windows
    (outages never couple rounds)."""
    faults = schedule.active_faults
    has_outage = faults is not None and faults.outage_rate > 0.0
    rows = []
    row_deadlines: List[Optional[float]] = []
    row_outages: List[Optional[np.ndarray]] = []
    meta = []            # (b, r, rem_start, row index or None)
    for b, case in enumerate(cases):
        for r in range(schedule.n_rounds):
            clients_r, _, rem_start, _ = _round_setup(case, schedule, r, {})
            if not clients_r:
                meta.append((b, r, rem_start, None))
                continue
            meta.append((b, r, rem_start, len(rows)))
            rows.append(_row_case(case, clients_r, r))
            row_deadlines.append(schedule.deadline(r))
            if has_outage:
                row_outages.append(faults.outage_windows(
                    r, _case_n_pons(case), case.seed))
    has_deadline = schedule.deadline_s is not None
    with maybe_span(collector, "timeline:folded", rows=len(rows),
                    rounds=schedule.n_rounds):
        results = _round_sweep(
            cfg, rows, t_round_hint=t_round_hint, max_t=max_t,
            ul_deadline_s=row_deadlines if has_deadline else None,
            ul_outage_s=row_outages if has_outage else None,
            collector=collector, backend=backend, device=device,
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
        if collector is not None:
            _observe_round(collector, cases[b], rnd, schedule.deadline(r))
    return out


def _jobs_schedule_check(schedule: TimelineSchedule) -> None:
    """Multi-job timelines fold by construction: every schedule feature
    that couples rounds or rewrites a round's workload is refused (per
    job cadence goes through ``JobSpec.period``/``phase``)."""
    if (schedule.membership is not None
            or schedule.m_ud_bits is not None
            or schedule.deadline_s is not None
            or schedule.buffer_k is not None
            or schedule.active_faults is not None
            or schedule.quorum_frac is not None):
        raise ValueError(
            "multi-job timelines need a plain schedule (n_rounds "
            "only): membership masks, per-round update sizes, "
            "deadlines, async buffering, fault injection and quorum "
            "extension are single-job features — encode per-job "
            "cadence via JobSpec.period/phase instead"
        )


def _folded_jobs(cfg, cases, schedule, mode, t_round_hint, max_t, backend,
                 device, collector=None):
    """The folded driver of multi-tenant cases: each round keeps the jobs
    active under their cadence (``JobSpec.active_in``), the round axis
    folds into the engine's batch as in :func:`_folded`, and each job's
    sync lands in ``TimelineRound.job_sync``."""
    if not all(case.jobs is not None for case in cases):
        raise ValueError(
            "a timeline sweep cannot mix multi-job and single-job "
            "cases; split them into separate sweeps"
        )
    _jobs_schedule_check(schedule)
    if mode not in ("auto", "folded"):
        raise ValueError(
            "multi-job timelines have independent rounds and always "
            f"fold; mode {mode!r} is unavailable"
        )
    rows = []
    meta = []            # (b, r, rem_start, row index or None)
    for b, case in enumerate(cases):
        for r in range(schedule.n_rounds):
            active = tuple(j for j in case.jobs if j.active_in(r))
            keep = {cid for j in active for cid in j.clients}
            clients_r = [c for c in case.workload.clients
                         if c.client_id in keep]
            rem_start = {c.client_id: c.m_ud_bits for c in clients_r}
            if not clients_r:
                meta.append((b, r, rem_start, None))
                continue
            wl = FLRoundWorkload(
                clients=clients_r,
                model_bits=case.workload.model_bits,
                t_aggregate=case.workload.t_aggregate,
            )
            meta.append((b, r, rem_start, len(rows)))
            rows.append(replace(case, workload=wl, stream_round=r,
                                jobs=active))
    with maybe_span(collector, "timeline:folded-jobs", rows=len(rows),
                    rounds=schedule.n_rounds):
        results = _round_sweep(
            cfg, rows, t_round_hint=t_round_hint, max_t=max_t,
            collector=collector, backend=backend, device=device,
        ) if rows else []
    out = [TimelineResult(policy=c.policy, load=c.load, seed=c.seed,
                          rounds=[]) for c in cases]
    t_now = [0.0] * len(cases)
    for b, r, rem_start, ridx in meta:
        res = results[ridx] if ridx is not None else None
        rnd, _ = _round_view(
            r, t_now[b], res, rem_start,
            cases[b].workload.t_aggregate, "defer",
        )
        if res is not None and res.job_stats:
            rnd.job_sync = {jid: js.sync_time
                            for jid, js in res.job_stats.items()}
        out[b].rounds.append(rnd)
        t_now[b] += rnd.sync_time
        if collector is not None:
            _observe_round(collector, cases[b], rnd, None)
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
    Multi-job cases always fold and report each job's sync in
    ``TimelineRound.job_sync``. ``collector`` records the engine's phase
    metrics, each round, upload delays, deadline slack, staleness and
    fault and quorum events; an async round's probe pass is not recorded.
    """
    cases = _validate(cases, schedule)
    run = (cfg, cases, schedule, t_round_hint, max_t, backend, device,
           collector)
    if any(case.jobs is not None for case in cases):
        return _folded_jobs(cfg, cases, schedule, mode, t_round_hint,
                            max_t, backend, device, collector)
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
                "deferral, dropout/loss retries or quorum extension); "
                "folded mode requires independent rounds — no "
                "deadline or drop/partial policies, and at most "
                "outage-only fault injection"
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
    equal :func:`simulate_timeline_sweep`'s. Multi-job cases run the
    folded jobs driver: their rounds are independent, so the two
    coincide."""
    cases = _validate(cases, schedule)
    if any(case.jobs is not None for case in cases):
        return _folded_jobs(cfg, cases, schedule, "auto", t_round_hint,
                            max_t, backend, device, collector)
    run = (cfg, cases, schedule, t_round_hint, max_t, backend, device,
           collector)
    return _async(*run) if schedule.asynchronous else _sequential(*run)


# ---------------------------------------------------------------------------
# cycle-level oracle
# ---------------------------------------------------------------------------


def simulate_timeline_reference(cfg, cases: Sequence[SweepCase],
                                schedule: TimelineSchedule,
                                t_round_hint: float = 10.0,
                                max_t: float = 600.0, *,
                                device=DEFAULT_DEVICE,
                                ) -> List[TimelineResult]:
    """The timeline, round by round, on the cycle-by-cycle simulator.

    Every round builds the simulator afresh and feeds it the engine's
    counter-based arrival streams (``CounterStream.source``, drawn on
    ``device``), so the engine-backed modes must reproduce its syncs and
    per-round bits (rtol 1e-6): elastic membership, the three deadline
    policies, quorum extension, faults and async rounds (the same
    two-pass k-th-completion rule, on fresh stream cursors each pass).
    """
    from repro_torch.kernels.traffic.ops import make_stream_key
    from repro_torch.net.multi_pon import (
        MultiPonTopology,
        pon_bg_rates,
        simulate_multi_pon_round,
    )
    from repro_torch.net.sim import simulate_round
    from repro_torch.net.traffic import CounterStream

    device = resolve_device(device)
    cases = _validate(cases, schedule)
    policy = schedule.deadline_policy
    quorum = schedule.quorum_frac
    out = []
    for case in cases:
        carry: Dict[int, float] = {}
        entry: Dict[int, int] = {}
        fstate = _FaultState()
        t_now = 0.0
        res = TimelineResult(policy=case.policy, load=case.load,
                             seed=case.seed, rounds=[])
        for r in range(schedule.n_rounds):
            clients_r, no_dl, rem_start, drops = _round_setup(
                case, schedule, r, carry, fstate.retries
            )
            for cid in rem_start:
                entry.setdefault(cid, r)
            if not clients_r:
                rnd, carry = _round_view(
                    r, t_now, None, rem_start,
                    case.workload.t_aggregate, policy, entry,
                )
                res.rounds.append(rnd)
                t_now += rnd.sync_time
                continue
            wl = FLRoundWorkload(
                clients=clients_r,
                model_bits=case.workload.model_bits,
                t_aggregate=case.workload.t_aggregate,
            )
            faults = schedule.active_faults
            outage = (faults.outage_windows(r, _case_n_pons(case),
                                            case.seed)
                      if faults is not None and faults.outage_rate > 0.0
                      else None)

            def run_ref(deadline):
                """One reference round under ``deadline``, on fresh
                stream cursors, so that the async two passes replay
                the same arrivals."""
                if case.topology is not None and not case.topology.trivial:
                    # the multi-PON oracle keys its own
                    # (seed, phase, round, pon) counter streams
                    return simulate_multi_pon_round(
                        cfg, case.topology, wl, case.load, case.policy,
                        seed=case.seed, t_round_hint=t_round_hint,
                        max_t=max_t, ul_deadline_s=deadline,
                        no_dl_ids=no_dl, stream_round=r,
                        ul_outage_s=outage, device=device,
                    )
                # the engine's single-PON background rate
                per_onu = pon_bg_rates(
                    wl.clients, wl.model_bits, case.load, cfg,
                    MultiPonTopology(), t_round_hint)[0]
                streams = [
                    CounterStream(
                        make_stream_key(case.seed, phase, r), per_onu,
                        cfg.cycle_time_s, cfg.n_onus,
                        burst_packets=cfg.bg_burst_packets, device=device,
                    )
                    for phase in (0, 1)
                ]
                return simulate_round(
                    cfg, wl, case.load, case.policy, seed=case.seed,
                    t_round_hint=t_round_hint, backend="reference",
                    _dl_sources=[streams[0].source(i)
                                 for i in range(cfg.n_onus)],
                    _ul_sources=[streams[1].source(i)
                                 for i in range(cfg.n_onus)],
                    ul_deadline_s=deadline,
                    no_dl_ids=no_dl,
                    ul_outage_s=(None if outage is None else
                                 (float(outage[0, 0]),
                                  float(outage[0, 1]))),
                    device=device,
                )

            quorum_met: Optional[bool] = None
            extensions = 0
            if schedule.asynchronous:
                free = run_ref(None)
                faulted = _round_faulted(schedule, case, r, rem_start,
                                         drops)
                result = run_ref(
                    _kth_completion(free, rem_start, schedule.buffer_k,
                                    faulted)
                )
            elif quorum is not None:
                # the engine's extend-until-met loop: the same counter
                # streams make each re-run a superset of the last pass
                faulted = _round_faulted(schedule, case, r, rem_start,
                                         drops)
                need = max(1, math.ceil(quorum * len(rem_start)))
                dl = schedule.deadline(r)
                result = run_ref(dl)
                while True:
                    got = len(_effective_arrived(result, rem_start,
                                                 faulted))
                    quorum_met = got >= need
                    if (quorum_met
                            or extensions >= schedule.quorum_max_extends):
                        break
                    dl = float(dl) * 2.0
                    extensions += 1
                    result = run_ref(dl)
            else:
                result = run_ref(schedule.deadline(r))
            rnd, carry = _round_view(
                r, t_now, result, rem_start,
                case.workload.t_aggregate, policy, entry,
            )
            rnd.quorum_met = quorum_met
            rnd.deadline_extensions = extensions
            carry = _apply_round_faults(
                schedule, case, r, rnd, rem_start, carry, drops, fstate,
            )
            entry = {cid: ent for cid, ent in entry.items()
                     if cid in carry or cid in fstate.retries}
            res.rounds.append(rnd)
            t_now += rnd.sync_time
        out.append(res)
    return out
