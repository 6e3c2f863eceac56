"""Concurrent multi-tenant FL jobs sharing one PON and CPS substrate.

The port of ``repro.net.jobs``. Several federated jobs, with their own models, update sizes, weights and round cadences,
contend for the same PON cycles and the same CPS uplink:

* :class:`JobSpec`: one tenant job, its clients, model size (its
  download, and the rate its background share is priced at), weight,
  soft deadline and cadence (``period``/``phase``) on a timeline;
* :func:`job_fair_split`: each cycle's capacity split across jobs by
  the fairness policy, ``"maxmin"`` (the CPS waterfill over the job
  axis), ``"weighted"`` (a water level proportional to the weights) or
  ``"deadline"`` (earliest slack first), as torch tensors on the
  engine's device; rows whose demand fits pass through untouched;
* :class:`JobRoundStats`: a job's last upload per ONU, per PON (OLT)
  and its sync time at the CPS;
* :func:`simulate_jobs_round_reference`: the cycle-by-cycle oracle of
  one multi-job round, which the engine's job axis is held to (rtol
  1e-6); it calls the same ``job_fair_split`` and CPS waterfill, on
  host copies, so it pins the cycle's sequencing.

Every sum whose order can move a bit is taken in numpy's order:
totals with ``np_sum`` (pairwise, as ``ndarray.sum``), prefixes with
``seq_cumsum`` (left to right, as ``np.cumsum``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import (
    DEFAULT_DEVICE,
    FLOAT,
    np_sum,
    resolve_device,
    seq_cumsum,
)
from repro_torch.core.scheduler import schedule_slots, slots_to_arrays
from repro_torch.core.slicing import ClientProfile, compute_slice
from repro_torch.net.dba import OnuQueue
from repro_torch.net.multi_pon import (
    MultiPonTopology,
    cps_waterfill,
    host_waterfill,
    pon_bg_rates,
)
from repro_torch.net.traffic import counter_streams_for_pons

__all__ = [
    "FAIRNESS_POLICIES",
    "JobSpec",
    "JobRoundStats",
    "job_fair_split",
    "validate_case_jobs",
    "compute_job_stats",
    "make_competing_jobs",
    "simulate_jobs_round_reference",
]

FAIRNESS_POLICIES = ("maxmin", "weighted", "deadline")

CAP_EPS = 1e-9                  # the engine's capacity-exhausted threshold


@dataclass(frozen=True)
class JobSpec:
    """One tenant FL job contending for the shared substrate.

    ``clients`` are global client ids, placed on ONUs as a workload's
    ``ClientProfile`` ids are; the jobs of a case partition its
    workload's clients (:func:`validate_case_jobs`). ``model_bits`` is
    the job's global-model size: its download, and the rate its
    training traffic is priced at in the background load. Update sizes
    stay on the workload's ``ClientProfile.m_ud_bits``. ``weight`` feeds
    the ``"weighted"`` policy; ``deadline_s`` is a soft deadline the
    ``"deadline"`` policy reads as slack (it never cuts service).
    ``period``/``phase``: the job trains in round ``r`` iff
    ``r >= phase`` and ``(r - phase) % period == 0``.
    """

    job_id: int
    clients: Tuple[int, ...]
    model_bits: float
    weight: float = 1.0
    deadline_s: Optional[float] = None
    period: int = 1
    phase: int = 0
    t_aggregate: float = 0.0

    def __post_init__(self):
        object.__setattr__(
            self, "clients", tuple(int(c) for c in self.clients)
        )
        if not self.clients:
            raise ValueError(f"job {self.job_id} has no clients")
        if float(self.model_bits) <= 0.0:
            raise ValueError(f"job {self.job_id}: model_bits must be > 0")
        if float(self.weight) <= 0.0:
            raise ValueError(f"job {self.job_id}: weight must be > 0")
        if int(self.period) < 1:
            raise ValueError(f"job {self.job_id}: period must be >= 1")
        if int(self.phase) < 0:
            raise ValueError(f"job {self.job_id}: phase must be >= 0")

    def active_in(self, round_index: int) -> bool:
        """Does this job train in timeline round ``round_index``?"""
        r = int(round_index) - int(self.phase)
        return r >= 0 and r % int(self.period) == 0


@dataclass(frozen=True)
class JobRoundStats:
    """Hierarchical aggregation times of one job in one round.

    ``onu_done``: global ONU id -> the last upload of the job's clients
    through that ONU; ``olt_done``: PON index -> the last of its ONUs'
    times; ``sync_time``: the last client overall plus the job's
    ``t_aggregate``.
    """

    job_id: int
    sync_time: float
    onu_done: Dict[int, float] = field(default_factory=dict)
    olt_done: Dict[int, float] = field(default_factory=dict)
    n_clients: int = 0


def validate_case_jobs(jobs: Sequence[JobSpec], workload) -> None:
    """Jobs must partition the workload's client ids exactly."""
    ids = [job.job_id for job in jobs]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate job_id in jobs: {sorted(ids)}")
    owner: Dict[int, int] = {}
    for job in jobs:
        for cid in job.clients:
            if cid in owner:
                raise ValueError(
                    f"client {cid} belongs to jobs {owner[cid]} and "
                    f"{job.job_id}; jobs must partition the workload"
                )
            owner[cid] = job.job_id
    wl_ids = {c.client_id for c in workload.clients}
    missing = sorted(wl_ids - owner.keys())
    extra = sorted(owner.keys() - wl_ids)
    if missing or extra:
        raise ValueError(
            "jobs must partition workload.clients exactly; "
            f"unassigned clients {missing}, job clients not in the "
            f"workload {extra}"
        )


def _rows(x, demand: torch.Tensor) -> torch.Tensor:
    """``x`` (``None``, ``(J,)`` or ``(G, J)``) as a ``(G, J)`` float64
    tensor on ``demand``'s device."""
    return torch.as_tensor(x, dtype=FLOAT, device=demand.device
                           ).broadcast_to(demand.shape)


def job_fair_split(demand, cap, fairness: str = "maxmin",
                   weights=None, slack=None) -> torch.Tensor:
    """Split each row's capacity across jobs by the fairness policy.

    ``demand``: ``(G, J)`` per-row per-job cycle demand (or one ``(J,)``
    vector), a float64 tensor or array; ``cap``: a scalar or ``(G,)``.
    Returns grants of ``demand``'s shape on its device with ``out <=
    demand`` and ``sum(out) <= cap`` per row where the cap binds. Rows
    whose demand fits the cap pass through untouched under every policy.

    * ``"maxmin"``: :func:`repro_torch.net.multi_pon.cps_waterfill` over
      the job axis;
    * ``"weighted"``: ``out_j = min(d_j, w_j * mu)`` at the exact level:
      the jobs with the smallest ``d / w`` saturate first and leave the
      pool (unit weights give ``"maxmin"`` bit for bit);
    * ``"deadline"``: jobs in order of ``slack`` (stable: ties keep job
      order) take ``min(demand, room)`` of what is left in turn.
    """
    demand = torch.as_tensor(demand, dtype=FLOAT)
    if demand.dim() == 1:
        return job_fair_split(
            demand[None, :], cap, fairness,
            None if weights is None else _rows(weights, demand)[None, :],
            None if slack is None else _rows(slack, demand)[None, :],
        )[0]
    G, J = demand.shape
    cap_b = torch.as_tensor(cap, dtype=FLOAT, device=demand.device
                            ).broadcast_to((G,))
    if fairness == "maxmin":
        return cps_waterfill(demand, cap_b)
    if fairness not in FAIRNESS_POLICIES:
        raise ValueError(
            f"unknown fairness policy {fairness!r}; "
            f"have {FAIRNESS_POLICIES}"
        )
    over = np_sum(demand) > cap_b + CAP_EPS
    if not bool(over.any()):
        return demand.clone()
    # rows are independent: every row is split, the over rows kept
    c = cap_b[:, None]
    if fairness == "weighted":
        w = (torch.ones_like(demand) if weights is None
             else _rows(weights, demand))
        if bool((w <= 0.0).any()):
            raise ValueError("job weights must be positive")
        ratio = demand / w
        order = torch.argsort(ratio, dim=1, stable=True)
        d_s = torch.gather(demand, 1, order)
        w_s = torch.gather(w, 1, order)
        r_s = torch.gather(ratio, 1, order)
        prev = seq_cumsum(d_s) - d_s
        # after fully granting the k smallest-ratio jobs the rest split
        # the residual pro rata: mu_k = (cap - granted) / w_rest
        w_rest = np_sum(w)[:, None] - (seq_cumsum(w_s) - w_s)
        mu_k = (c - prev) / w_rest
        k = torch.argmax((mu_k <= r_s).to(torch.int8), dim=1, keepdim=True)
        mu = torch.gather(mu_k, 1, k)
        split = torch.minimum(demand, w * mu)
    else:
        # "deadline": earliest slack first, prefix-room greedy
        sl = (torch.zeros_like(demand) if slack is None
              else _rows(slack, demand))
        order = torch.argsort(sl, dim=1, stable=True)
        d_s = torch.gather(demand, 1, order)
        room = c - (seq_cumsum(d_s) - d_s)
        g_s = torch.where(room > CAP_EPS, torch.minimum(d_s, room), 0.0)
        split = torch.empty_like(g_s).scatter_(1, order, g_s)
    return torch.where(over[:, None], split, demand)


def compute_job_stats(jobs: Sequence[JobSpec], ul_done: Dict[int, float],
                      n_onus: int, n_pons: int) -> Dict[int, JobRoundStats]:
    """Per-job ONU -> OLT -> CPS aggregation times from upload times."""
    total = n_onus * n_pons
    stats: Dict[int, JobRoundStats] = {}
    for job in jobs:
        times = {
            cid: float(ul_done[cid]) for cid in job.clients
            if cid in ul_done and np.isfinite(ul_done[cid])
        }
        onu_done: Dict[int, float] = {}
        for cid, t in times.items():
            onu = int(cid) % total
            onu_done[onu] = max(onu_done.get(onu, -np.inf), t)
        olt_done: Dict[int, float] = {}
        for onu, t in onu_done.items():
            p = onu // n_onus
            olt_done[p] = max(olt_done.get(p, -np.inf), t)
        sync = (max(times.values()) + job.t_aggregate if times
                else float("nan"))
        stats[job.job_id] = JobRoundStats(
            job_id=job.job_id, sync_time=sync, onu_done=onu_done,
            olt_done=olt_done, n_clients=len(times),
        )
    return stats


def make_competing_jobs(primary_clients: Sequence[int],
                        primary_model_bits: float, n_jobs: int,
                        clients_each: int = 2,
                        model_scale: float = 0.5,
                        t_ud: float = 2.0,
                        weight: float = 1.0,
                        ) -> Tuple[Tuple[JobSpec, ...],
                                   Tuple[ClientProfile, ...]]:
    """``n_jobs`` competitor jobs and their client profiles.

    Fresh client ids above the primary job's, ``clients_each`` a job,
    model size ``model_scale`` times the primary's (updates sized to the
    model), compute time ``t_ud``. Returns ``(jobs, profiles)``: append
    the profiles to the workload's clients and the jobs, after the
    primary's own :class:`JobSpec`, to the case.
    """
    ids = [int(c) for c in primary_clients]
    if not ids:
        raise ValueError("primary_clients must be non-empty")
    nid = max(ids) + 1
    mb = float(primary_model_bits) * float(model_scale)
    jobs: List[JobSpec] = []
    profiles: List[ClientProfile] = []
    for j in range(int(n_jobs)):
        cids = tuple(range(nid, nid + int(clients_each)))
        nid += int(clients_each)
        jobs.append(JobSpec(job_id=j + 1, clients=cids, model_bits=mb,
                            weight=weight))
        profiles.extend(
            ClientProfile(client_id=cid, t_ud=t_ud, t_dl=0.0,
                          m_ud_bits=mb)
            for cid in cids
        )
    return tuple(jobs), tuple(profiles)


# ---------------------------------------------------------------------------
# cycle-level oracle
# ---------------------------------------------------------------------------


def _seq_waterfill(entries, cap: float) -> Dict[int, float]:
    """The engine's waterfill one queue at a time: oldest first (ties by
    queue index), prefix-room grants; every queue in full, unsorted,
    while the total demand sits a bit under ``cap``.

    ``entries``: ``(hol_key, queue_index, backlog)`` triples.
    """
    total = sum(b for _, _, b in entries)
    if total <= cap - 1.0:
        return {i: b for _, i, b in entries}
    grants: Dict[int, float] = {}
    acc = 0.0
    for _, i, b in sorted(entries, key=lambda e: (e[0], e[1])):
        room = cap - acc
        grants[i] = min(b, room) if room > CAP_EPS else 0.0
        acc += b
    return grants


def simulate_jobs_round_reference(cfg, case, t_round_hint: float = 10.0,
                                  max_t: float = 600.0, *,
                                  device=DEFAULT_DEVICE):
    """One multi-job round of ``case`` on the cycle-by-cycle simulator.

    Each cycle follows the engine's sequence: arrivals (background
    first, then newly ready FL clients), the CPS waterfill over each
    PON's total demand (FCFS) or over the ``(pon, job)`` shares (BS),
    the background's oldest-first waterfill, :func:`job_fair_split`
    across jobs, then each job's oldest-first grants within its share.
    Queues are owner-tagged ``OnuQueue`` FIFOs per ``(pon, job, local
    onu)``, credited by ``net.sim._credit``; background comes from the
    engine's counter streams, drawn on ``device``. ``no_dl_ids`` and
    injected arrival matrices are refused.
    """
    from repro_torch.net.sim import RoundResult, _credit

    device = resolve_device(device)
    jobs: Tuple[JobSpec, ...] = tuple(case.jobs)
    validate_case_jobs(jobs, case.workload)
    if case.no_dl_ids:
        raise ValueError("the jobs oracle does not model no_dl_ids")
    if case.dl_arrivals is not None or case.ul_arrivals is not None:
        raise ValueError(
            "the jobs oracle draws arrivals from counter streams; "
            "injected matrices are a single-tenant parity hook"
        )
    fairness = case.fairness
    if fairness not in FAIRNESS_POLICIES:
        raise ValueError(
            f"unknown fairness policy {fairness!r}; "
            f"have {FAIRNESS_POLICIES}"
        )
    topo = case.topology if case.topology is not None else MultiPonTopology()
    P = topo.n_pons
    n_local = cfg.n_onus
    total = P * n_local
    clients = list(case.workload.clients)
    J = len(jobs)
    jidx_of = {cid: j for j, job in enumerate(jobs) for cid in job.clients}
    mb_of = {cid: float(job.model_bits) for job in jobs
             for cid in job.clients}
    if case.policy not in ("fcfs", "bs"):
        raise ValueError(f"unknown policy {case.policy!r}")
    if case.policy == "bs":
        bad = [c.client_id for c in clients if c.client_id >= total]
        if bad:
            raise ValueError(
                f"bs policy requires client_id < n_onus * n_pons; got {bad}"
            )
    pon_of = {c.client_id: topo.pon_of(c.client_id, cfg) for c in clients}
    onu_of = {c.client_id: topo.local_onu(c.client_id, cfg)
              for c in clients}
    rates = topo.rates(cfg)
    cap_p = topo.capacity_bits(cfg)
    cps_cap = topo.cps_capacity_bits(cfg)
    per_onu = pon_bg_rates(clients, case.workload.model_bits, case.load,
                           cfg, topo, t_round_hint,
                           model_bits_by_client=mb_of)
    cyc = cfg.cycle_time_s
    prop = cfg.propagation_s
    weights = np.broadcast_to(
        np.array([float(job.weight) for job in jobs]), (P, J)
    ).copy()
    dl_j = np.broadcast_to(
        np.array([np.inf if job.deadline_s is None
                  else float(job.deadline_s) for job in jobs]),
        (P, J),
    )

    def fresh_queues():
        return [
            [[OnuQueue(i) for i in range(n_local)] for _ in range(J)]
            for _ in range(P)
        ]

    def push_pending(flq, pending, remaining, t):
        for cid, t_ready in list(pending.items()):
            if t_ready <= t + cyc:
                flq[pon_of[cid]][jidx_of[cid]][onu_of[cid]].push(
                    ("fl", cid), remaining[cid], max(t_ready, t)
                )
                del pending[cid]

    def fl_demand(flq) -> np.ndarray:
        demand = np.zeros((P, J))
        for p in range(P):
            for j in range(J):
                demand[p, j] = sum(q.backlog for q in flq[p][j])
        return demand

    def serve_jobs(flq, shares, remaining, done, t):
        for p in range(P):
            for j in range(J):
                gj = _seq_waterfill(
                    [(q.hol_time, i, q.backlog)
                     for i, q in enumerate(flq[p][j]) if q.backlog > 0.0],
                    float(shares[p, j]),
                )
                for i, g in gj.items():
                    if g > 0.0:
                        served = flq[p][j][i].serve(g)
                        _credit(served, remaining, done, t, cfg)

    def fcfs_phase(bits0, ready, phase_idx):
        bgq = [[OnuQueue(i) for i in range(n_local)] for _ in range(P)]
        flq = fresh_queues()
        streams = counter_streams_for_pons(
            case.seed, phase_idx, per_onu, cyc, n_local,
            cfg.bg_burst_packets, round_index=case.stream_round,
            device=device,
        )
        sources = [[streams[p].source(i) for i in range(n_local)]
                   for p in range(P)]
        remaining = dict(bits0)
        pending = dict(ready)
        done: Dict[int, float] = {}
        t = 0.0
        while remaining and t < max_t:
            for p in range(P):
                for q, src in zip(bgq[p], sources[p]):
                    q.push("bg", src.arrivals(cyc), t)
            push_pending(flq, pending, remaining, t)
            demand = fl_demand(flq)
            if cps_cap is None:
                eff = np.asarray(cap_p, np.float64).copy()
            else:
                want = np.minimum(
                    np.array([
                        sum(q.backlog for q in bgq[p]) + demand[p].sum()
                        for p in range(P)
                    ]),
                    cap_p,
                )
                eff = host_waterfill(want, cps_cap)
            cap_fl = np.zeros(P)
            bg_grants = []
            for p in range(P):
                g = _seq_waterfill(
                    [(q.hol_time, i, q.backlog)
                     for i, q in enumerate(bgq[p]) if q.backlog > 0.0],
                    float(eff[p]),
                )
                bg_grants.append(g)
                cap_fl[p] = eff[p] - sum(g.values())
            shares = job_fair_split(demand, cap_fl, fairness,
                                    weights=weights, slack=dl_j - t).numpy()
            for p in range(P):
                for i, g in bg_grants[p].items():
                    if g > 0.0:
                        bgq[p][i].serve(g)
            serve_jobs(flq, shares, remaining, done, t)
            t += cyc
        for cid in list(remaining):
            done[cid] = t + prop
        return done

    def bs_phase(bits0, ready, dl_done):
        flq = fresh_queues()
        slots_p: List[list] = []
        for p in range(P):
            slot_list = []
            for j, job in enumerate(jobs):
                jset = set(job.clients)
                profs = [
                    ClientProfile(
                        client_id=c.client_id, t_ud=c.t_ud,
                        t_dl=dl_done[c.client_id],
                        m_ud_bits=c.m_ud_bits, distance_m=c.distance_m,
                    )
                    for c in clients
                    if pon_of[c.client_id] == p and c.client_id in jset
                ]
                if not profs:
                    continue
                spec = compute_slice(
                    profs, t_current=0.0, t_round=0.0,
                    capacity_bps=float(rates[p] * cfg.efficiency), h=1,
                )
                arr = slots_to_arrays(
                    schedule_slots(profs, spec, round_start=0.0)
                )
                for s in range(len(arr["client_id"])):
                    slot_list.append((
                        j, int(arr["client_id"][s]) % n_local,
                        float(arr["t_start"][s]), float(arr["t_end"][s]),
                        float(spec.bandwidth_bps),
                    ))
            slots_p.append(slot_list)
        remaining = dict(bits0)
        pending = dict(ready)
        done: Dict[int, float] = {}
        t = 0.0
        while remaining and t < max_t:
            push_pending(flq, pending, remaining, t)
            want_slots = []
            demand = np.zeros((P, J))
            for p in range(P):
                ws = []
                for (j, onu, ts, te, rate) in slots_p[p]:
                    te_g = te + cyc
                    if ts < t + cyc and te_g > t:
                        w = rate * max(
                            min(te_g, t + cyc) - max(ts, t), 0.0
                        )
                    elif te_g <= t:
                        # the engine's best-effort tail: an expired slot
                        # keeps asking at the slice rate, so backlog
                        # left by inter-job contention drains
                        w = rate * cyc
                    else:
                        w = 0.0
                    w = min(w, flq[p][j][onu].backlog)
                    w = w if w > 0.0 else 0.0
                    ws.append(w)
                    demand[p, j] += w
                want_slots.append(ws)
            shares = job_fair_split(demand, cap_p, fairness,
                                    weights=weights, slack=dl_j - t).numpy()
            if cps_cap is not None:
                # the (case, pon, job) CPS waterfill: each PON's shares
                # re-capped by the shared uplink, job-minor
                shares = host_waterfill(
                    shares.reshape(-1), cps_cap
                ).reshape(P, J)
            for p in range(P):
                acc = np.zeros(J)
                grants_onu: Dict[Tuple[int, int], float] = {}
                for (j, onu, ts, te, rate), w in zip(slots_p[p],
                                                     want_slots[p]):
                    g = min(w, max(float(shares[p, j]) - acc[j], 0.0))
                    acc[j] += w
                    if g > 0.0:
                        grants_onu[(j, onu)] = (
                            grants_onu.get((j, onu), 0.0) + g
                        )
                for (j, onu), g in grants_onu.items():
                    served = flq[p][j][onu].serve(g)
                    _credit(served, remaining, done, t, cfg)
            t += cyc
        for cid in list(remaining):
            done[cid] = t + prop
        return done

    if case.policy == "bs":
        dl_done = {
            c.client_id: (mb_of[c.client_id]
                          / (rates[pon_of[c.client_id]] * cfg.efficiency)
                          + prop)
            for c in clients
        }
    else:
        dl_done = fcfs_phase(
            {c.client_id: mb_of[c.client_id] for c in clients},
            {c.client_id: 0.0 for c in clients}, 0,
        )
    ready = {c.client_id: dl_done[c.client_id] + c.t_ud for c in clients}
    bits_ul = {c.client_id: c.m_ud_bits for c in clients}
    if case.policy == "bs":
        ul_done = bs_phase(bits_ul, dict(ready), dl_done)
    else:
        ul_done = fcfs_phase(bits_ul, dict(ready), 1)
    sync = max(ul_done.values()) + case.workload.t_aggregate
    return RoundResult(
        policy=case.policy,
        sync_time=sync,
        dl_done=dl_done,
        ready=ready,
        ul_done=ul_done,
        compute_bound=max(ready.values()),
        load=case.load,
        job_stats=compute_job_stats(jobs, ul_done, n_local, P),
    )
