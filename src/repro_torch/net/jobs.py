"""Concurrent multi-tenant FL jobs sharing one PON and CPS substrate.

The port of ``repro.net.jobs`` (its cycle-level oracle
``simulate_jobs_round_reference`` is not ported). Several federated
jobs, with their own models, update sizes, weights and round cadences,
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
  and its sync time at the CPS.

Every sum whose order can move a bit is taken in numpy's order:
totals with ``np_sum`` (pairwise, as ``ndarray.sum``), prefixes with
``seq_cumsum`` (left to right, as ``np.cumsum``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import FLOAT, np_sum, seq_cumsum
from repro_torch.core.slicing import ClientProfile
from repro_torch.net.multi_pon import cps_waterfill

__all__ = [
    "FAIRNESS_POLICIES",
    "JobSpec",
    "JobRoundStats",
    "job_fair_split",
    "validate_case_jobs",
    "compute_job_stats",
    "make_competing_jobs",
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
