"""FL × PON co-simulation: real training on the port plus the network's
timing, round by round.

The port of ``repro.fl.simulation``. ``CPSServer`` trains (local SGD on
the LEAF CNN, update compression, FedAvg or the FedBuff merge); the
round engine and the multi-round timeline (``repro_torch.net``) give
each round its synchronisation time on ``device``.

Timing backends of :meth:`FLNetworkCoSim.run`:

* ``"timeline"`` (default): after training, the whole timeline runs as
  one stacked simulation: the rounds' client sets become a membership
  mask over the union of clients, their upload sizes the schedule's
  ``m_ud_bits``, every round × timing seed a row of the engine's batch.
* ``"per_round"``: one engine call a round, cached by client set (the
  BS slice changes only with membership).

With a deadline or ``mode="async"`` timing and learning couple: the
timeline runs first and decides who arrives at each aggregation, how
stale and with what served fraction, and training follows it update by
update (:meth:`FLNetworkCoSim._run_coupled`). Fault injection
(``CoSimConfig.faults``/``retry``/``quorum_frac``) rides that coupled
timeline; outage-only faults also reach the decoupled one. Competing
tenant jobs (``CoSimConfig.jobs``) contend for the PON and CPS with
the FL task, which becomes job 0 and whose sync gates each round.

A ``collector`` (``repro_torch.obs.Collector``, on ``CoSimConfig`` or
``run(collector=...)``) reaches every network simulation the co-sim
runs and gets an ``fl_round`` event a round (and an ``fl:train_round``
span around each synchronous training round).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace as _dc_replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch._device import DEFAULT_DEVICE
from repro_torch.core.slicing import ClientProfile
from repro_torch.faults import FaultSchedule, RetryPolicy
from repro_torch.fl.server import CPSServer, PendingUpdate
from repro_torch.net.api import SweepSpec, simulate
from repro_torch.net.engine import SweepCase
from repro_torch.net.jobs import JobSpec
from repro_torch.net.multi_pon import MultiPonTopology
from repro_torch.net.sim import FLRoundWorkload, PONConfig
from repro_torch.net.timeline import TimelineSchedule
from repro_torch.obs.trace import maybe_span


@dataclass
class CoSimConfig:
    policy: str = "bs"              # "bs" | "fcfs"
    total_load: float = 0.8
    model_bits: float = 26.416e6    # global model size (fp32 downlink)
    upload_bits: Optional[float] = None  # per-client M_i^UD; None = model_bits
    pon: PONConfig = field(default_factory=PONConfig)
    timing_seeds: int = 2           # average the net-sim over this many seeds
    # several wavelength segments sharing a CPS uplink: ``pon`` then
    # describes one segment (None = a single PON)
    topology: Optional[MultiPonTopology] = None
    # a repro_torch.obs.Collector: metrics of every network simulation
    # and an fl_round event a round
    collector: Optional[object] = None
    # fault injection (repro_torch.faults): dropout/loss faults and
    # quorum aggregation need the coupled deadline/async path (who
    # retries or arrives is an event); outage-only faults also reach
    # the decoupled timeline
    faults: Optional[FaultSchedule] = None
    retry: Optional[RetryPolicy] = None
    quorum_frac: Optional[float] = None
    # multi-tenant contention: competitor jobs (net.jobs.JobSpec,
    # job_id >= 1) sharing the PON and CPS with this FL task, and the
    # ClientProfiles of their client ids; the FL task becomes job 0 and
    # each round's capacity is split by ``fairness``
    jobs: Optional[Tuple[JobSpec, ...]] = None
    job_clients: Optional[Tuple[ClientProfile, ...]] = None
    fairness: str = "maxmin"

    @classmethod
    def from_fed_model(cls, model_cfg, compress: str = "int8", **kw):
        """``model_bits`` the fp32 size of the global model (the
        downlink broadcast) and ``upload_bits`` one pod's compressed
        upload (``repro_torch.dist.stepfns.fed_update_bits``)."""
        from repro_torch.dist.stepfns import fed_update_bits

        return cls(
            model_bits=float(fed_update_bits(model_cfg, "none")),
            upload_bits=float(fed_update_bits(model_cfg, compress)),
            **kw,
        )


@dataclass
class CoSimResult:
    rounds: List[dict]
    total_time_s: float
    sync_time_s: float              # steady-state per-round sync time
    policy: str
    load: float

    def time_to_metric(self, target: float) -> Optional[float]:
        """Wall-clock until eval_metric >= target (None if never)."""
        t = 0.0
        for r in self.rounds:
            t += r["sync_time_s"]
            if r["eval_metric"] is not None and r["eval_metric"] >= target:
                return t
        return None


class FLNetworkCoSim:
    """Couples ``server``'s training to the network timing of ``cfg``;
    every network simulation runs on ``device``."""

    def __init__(self, server: CPSServer, cfg: CoSimConfig, *,
                 device=DEFAULT_DEVICE):
        self.server = server
        self.cfg = cfg
        self.device = device
        self._timing_cache: Dict[Tuple, float] = {}
        self._update_bits_from_compression = False
        # the round engine's backend: None (the per-cycle loop) until a
        # run's ``spec`` names one
        self._backend: Optional[str] = None
        self._collector = cfg.collector

    def _simulate(self, cases, schedule=None):
        return simulate(SweepSpec(cases=tuple(cases), pon=self.cfg.pon,
                                  schedule=schedule, backend=self._backend),
                        collector=self._collector, device=self.device)

    def _cases(self, wl: FLRoundWorkload, seeds, jobs: Optional[tuple] = None,
               fairness: str = "maxmin") -> List[SweepCase]:
        return [SweepCase(workload=wl, load=self.cfg.total_load,
                          policy=self.cfg.policy, seed=s,
                          topology=self.cfg.topology, jobs=jobs,
                          fairness=fairness) for s in seeds]

    def _jobs_bundle(
        self, clients: List[ClientProfile],
    ) -> Tuple[List[ClientProfile], Optional[tuple]]:
        """``(workload clients with the tenants' clients, all jobs)``:
        the FL task becomes job 0 over the server's clients."""
        if self.cfg.jobs is None:
            return clients, None
        primary = JobSpec(
            job_id=0,
            clients=tuple(sorted(c.client_id for c in clients)),
            model_bits=float(self.cfg.model_bits),
        )
        return (clients + list(self.cfg.job_clients or ()),
                (primary,) + tuple(self.cfg.jobs))

    def _round_sync_time(self, clients: List[ClientProfile]) -> float:
        # the key pins every cfg field the timing depends on, payload
        # sizes included, so a cfg changed between run() calls is not
        # served a stale timing
        key = (
            self.cfg.policy,
            round(self.cfg.total_load, 6),
            self.cfg.model_bits,
            self.cfg.upload_bits,
            self.cfg.pon,
            self.cfg.topology,
            self.cfg.jobs,
            self.cfg.job_clients,
            self.cfg.fairness,
            tuple(sorted((c.client_id, round(c.t_ud, 6), c.m_ud_bits)
                         for c in clients)),
        )
        if key not in self._timing_cache:
            wl_clients, jobs = self._jobs_bundle(clients)
            wl = FLRoundWorkload(clients=wl_clients,
                                 model_bits=self.cfg.model_bits)
            # all timing seeds as one stacked engine simulation
            results = self._simulate(self._cases(
                wl, range(self.cfg.timing_seeds), jobs, self.cfg.fairness))
            # a multi-tenant round waits for the FL task (job 0) alone:
            # the competitors contend but do not hold its aggregation
            self._timing_cache[key] = float(np.mean([
                r.sync_time if jobs is None else r.job_stats[0].sync_time
                for r in results]))
        return self._timing_cache[key]

    def _client_profiles(
        self, m_bits: Optional[float] = None,
    ) -> Tuple[List[ClientProfile], float]:
        if m_bits is None:
            m_bits = (
                self.cfg.upload_bits
                if self.cfg.upload_bits is not None
                else self.cfg.model_bits
            )
        profiles = [
            ClientProfile(
                client_id=c.client_id,
                t_ud=c.t_ud_s,
                t_dl=0.0,
                m_ud_bits=m_bits,
                distance_m=c.distance_m,
            )
            for c in self.server.clients
        ]
        return profiles, float(m_bits)

    def _round_profiles(self, log) -> Tuple[List[ClientProfile], float]:
        m_bits = None
        if self._update_bits_from_compression and log.n_arrived:
            m_bits = log.update_bits / max(log.n_arrived, 1)
        return self._client_profiles(m_bits)

    def _timeline_sync_times(
        self, per_round: List[List[ClientProfile]],
        m_bits: List[float],
    ) -> np.ndarray:
        """Per-round sync times, averaged over timing seeds, from one
        stacked multi-round simulation: the union of the rounds' clients
        is the workload, each round's participation the membership mask,
        its upload size the schedule's ``m_ud_bits``."""
        R = len(per_round)
        union: Dict[int, ClientProfile] = {}
        for profs in per_round:
            for p in profs:
                union.setdefault(p.client_id, p)
        ids = sorted(union)
        if self.cfg.jobs is not None:
            # multi-tenant timelines take a plain schedule, so the client
            # set and upload size must hold across rounds (per-job
            # cadence goes through JobSpec)
            static = all(
                {p.client_id for p in profs} == set(ids)
                for profs in per_round
            ) and len({float(b) for b in m_bits}) <= 1
            if not static or self.cfg.faults is not None:
                raise ValueError(
                    "multi-tenant co-simulation needs a static client "
                    "set, uniform upload size and no fault schedule "
                    "on the decoupled timeline backend; use "
                    "backend='per_round' for varying rounds"
                )
            wl_clients, jobs = self._jobs_bundle([union[c] for c in ids])
            wl = FLRoundWorkload(clients=wl_clients,
                                 model_bits=self.cfg.model_bits)
            results = self._simulate(
                self._cases(wl, range(self.cfg.timing_seeds), jobs,
                            self.cfg.fairness),
                TimelineSchedule(n_rounds=R))
            return np.mean([[rnd.job_sync[0] for rnd in r.rounds]
                            for r in results], axis=0)
        pos = {cid: j for j, cid in enumerate(ids)}
        membership = np.zeros((R, len(ids)), bool)
        for r, profs in enumerate(per_round):
            for p in profs:
                membership[r, pos[p.client_id]] = True
        wl = FLRoundWorkload(
            clients=[union[c] for c in ids],
            model_bits=self.cfg.model_bits,
        )
        schedule = TimelineSchedule(
            n_rounds=R, membership=membership,
            m_ud_bits=np.asarray(m_bits),
            faults=self.cfg.faults,
        )
        results = self._simulate(
            self._cases(wl, range(self.cfg.timing_seeds)), schedule)
        return np.mean([r.sync_times for r in results], axis=0)

    def _run_coupled(
        self,
        n_rounds: int,
        eval_fn: Optional[Callable],
        deadline_s,
        deadline_policy: str,
        buffer_k: Optional[int],
    ) -> CoSimResult:
        """Deadline/async co-simulation: the network decides per round
        who arrives, how stale and how complete, and training follows.

        Every client takes part in each round unless its previous upload
        is still in flight. Fresh participants train against the global
        model at their entry round (a ``failure_prob`` roll can lose the
        update, as in the sync path); the update applies at the
        aggregation the network delivers it to, discounted by staleness
        and served fraction (``fl.aggregation.fedbuff_merge``). One
        arrival realisation is followed, so ``timing_seeds`` must be 1.

        Faults (``cfg.faults``) ride the same timeline: a dropout or loss
        victim's trained update stays pending while its re-send is in
        flight (the retry re-sends the same payload, nothing retrains),
        a ``gave_up`` client drops it and trains fresh at its next
        entry, and ``cfg.quorum_frac`` gates each aggregation
        (``CPSServer.apply_updates`` keeps the previous global model
        below quorum).
        """
        if self.cfg.timing_seeds != 1:
            raise ValueError(
                "coupled deadline/async co-simulation follows one "
                "arrival realization; set timing_seeds=1 (who arrives "
                "per round is an event, not an averageable time)"
            )
        profiles, _ = self._client_profiles()
        wl = FLRoundWorkload(
            clients=profiles, model_bits=self.cfg.model_bits
        )
        schedule = TimelineSchedule(
            n_rounds=n_rounds, deadline_s=deadline_s,
            deadline_policy=deadline_policy, buffer_k=buffer_k,
            faults=self.cfg.faults, retry=self.cfg.retry,
            quorum_frac=self.cfg.quorum_frac,
        )
        net = self._simulate(self._cases(wl, (0,)), schedule)[0]
        by_id = {c.client_id: c for c in self.server.clients}
        pending: Dict[int, Optional[PendingUpdate]] = {}
        rounds = []
        total_time = 0.0
        for rnd in net.rounds:
            fresh = sorted(set(rnd.ul_bits) - set(pending))
            for cid in fresh:
                # a failed client's bits still cross the network, but its
                # update is lost: it contributes nothing on arrival
                pending[cid] = self.server.train_client_update(
                    by_id[cid], self.server.global_params,
                )
            items = []
            for cid in rnd.arrived:
                u = pending.pop(cid)
                if u is not None:
                    items.append((u, rnd.staleness.get(cid, 0), 1.0))
            for cid in sorted(rnd.partial):
                u = pending.pop(cid)
                frac = rnd.partial[cid]
                if u is not None and frac > 0.0:
                    items.append((u, 0, frac))
            for cid in rnd.dropped:
                pending.pop(cid, None)
            # fault outcomes: a failed (dropout) or lost (corrupted)
            # client keeps its trained update pending, the retry re-sends
            # the same payload; a client that gave up abandons it
            for cid in rnd.gave_up:
                pending.pop(cid, None)
            log = self.server.apply_updates(
                items, eval_fn=eval_fn,
                n_expected=(len(rnd.ul_bits)
                            if self.cfg.quorum_frac is not None else None),
                quorum_frac=self.cfg.quorum_frac,
            )
            log.sync_time_s = rnd.sync_time
            total_time += rnd.sync_time
            if self._collector is not None:
                self._collector.event(
                    "fl_round", mode="coupled", round=log.round_index,
                    sync_time_s=rnd.sync_time, n_arrived=log.n_arrived,
                    n_deferred=len(rnd.deferred),
                    n_dropped=len(rnd.dropped),
                    n_partial=len(rnd.partial),
                    n_failed=len(rnd.failed),
                    n_lost=len(rnd.lost),
                    quorum_met=rnd.quorum_met,
                    payload_bits=float(sum(rnd.ul_bits.values())),
                )
            rounds.append(
                {
                    "round": log.round_index,
                    "eval_metric": log.eval_metric,
                    "mean_loss": log.mean_loss,
                    "sync_time_s": rnd.sync_time,
                    "n_arrived": log.n_arrived,
                    "staleness": dict(rnd.staleness),
                    "n_failed": len(rnd.failed),
                    "n_lost": len(rnd.lost),
                    "quorum_met": log.quorum_met,
                }
            )
        return CoSimResult(
            rounds=rounds,
            total_time_s=total_time,
            sync_time_s=rounds[-1]["sync_time_s"] if rounds else 0.0,
            policy=self.cfg.policy,
            load=self.cfg.total_load,
        )

    def run(
        self,
        n_rounds: int,
        eval_fn: Optional[Callable] = None,
        update_bits_from_compression: bool = False,
        backend: str = "timeline",
        mode: str = "sync",
        deadline_s=None,
        deadline_policy: str = "defer",
        async_buffer: Optional[int] = None,
        collector=None,
        spec: Optional[SweepSpec] = None,
    ) -> CoSimResult:
        """Train ``n_rounds`` rounds and attach simulated network timing.

        ``spec`` (a schedule-free :class:`repro_torch.net.SweepSpec` with
        one template case) re-points the network side: its case gives
        policy, load, topology and fairness, ``spec.pon`` the PON
        config, and
        ``spec.backend`` the round engine's backend (``"jit"``: each
        transfer phase one launch of the fused phase kernel).
        ``backend="timeline"`` resolves all rounds' timings in one
        stacked simulation after training; ``"per_round"`` runs one
        engine call a round, cached by client set. ``mode="async"``
        (FedBuff, firing at the ``async_buffer``-th upload; default half
        the clients) or a ``deadline_s`` under ``deadline_policy`` runs
        the coupled co-simulation (:meth:`_run_coupled`). Upload sizes
        measured from compression (``update_bits_from_compression``)
        are a decoupled-path feature. ``collector`` overrides
        ``cfg.collector`` from this run on.
        """
        if collector is not None:
            self._collector = collector
        if spec is not None:
            spec.validate()
            if spec.schedule is not None:
                raise ValueError(
                    "the co-sim builds its own schedule from "
                    "n_rounds; pass a schedule-free spec"
                )
            if len(spec.cases) != 1:
                raise ValueError(
                    "co-sim spec needs exactly one template case (its "
                    "workload is replaced by the server's clients)"
                )
            case = spec.cases[0]
            self.cfg = _dc_replace(
                self.cfg, policy=case.policy, total_load=case.load,
                topology=case.topology, fairness=case.fairness,
                pon=spec.pon if spec.pon is not None else self.cfg.pon,
            )
            self._backend = spec.backend
            self._timing_cache.clear()
        if backend not in ("timeline", "per_round"):
            raise ValueError(f"unknown backend {backend!r}")
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {mode!r}")
        if async_buffer is not None:
            # an explicit buffer is the async request; with a deadline it
            # fails in TimelineSchedule's validation
            mode = "async"
        coupled = mode == "async" or deadline_s is not None
        if coupled and self.cfg.jobs is not None:
            raise ValueError(
                "multi-tenant contention (cfg.jobs) takes per-job "
                "deadlines (JobSpec.deadline_s, fairness='deadline'); "
                "round-level deadline/async coupling is single-tenant"
            )
        if not coupled:
            if (self.cfg.faults is not None
                    and self.cfg.faults.couples_rounds):
                raise ValueError(
                    "dropout/loss fault injection decides who retries "
                    "and who arrives per round — an event, not a "
                    "timing average; use the coupled path (deadline_s "
                    "or mode='async'). Outage-only faults are fine "
                    "decoupled."
                )
            if self.cfg.quorum_frac is not None:
                raise ValueError(
                    "quorum aggregation gates per-round arrivals; use "
                    "the coupled path (deadline_s, per "
                    "TimelineSchedule's quorum validation)"
                )
        if coupled:
            if update_bits_from_compression:
                raise ValueError(
                    "update_bits_from_compression needs the decoupled "
                    "path; coupled deadline/async timing runs before "
                    "training"
                )
            if mode == "async" and async_buffer is None:
                async_buffer = max(1, len(self.server.clients) // 2)
            return self._run_coupled(
                n_rounds, eval_fn, deadline_s, deadline_policy,
                async_buffer if mode == "async" else None,
            )
        self._update_bits_from_compression = update_bits_from_compression
        rounds = []
        per_round_profiles: List[List[ClientProfile]] = []
        per_round_bits: List[float] = []
        sync = 0.0
        total_time = 0.0
        for _ in range(n_rounds):
            with maybe_span(self._collector, "fl:train_round"):
                log = self.server.run_round(eval_fn=eval_fn)
            profiles, m_bits = self._round_profiles(log)
            per_round_profiles.append(profiles)
            per_round_bits.append(m_bits)
            if backend == "per_round":
                sync = self._round_sync_time(profiles)
                log.sync_time_s = sync
                total_time += sync
            if self._collector is not None:
                self._collector.event(
                    "fl_round", mode="sync", round=log.round_index,
                    n_arrived=log.n_arrived,
                    payload_bits=float(m_bits) * log.n_arrived,
                )
            rounds.append(
                {
                    "round": log.round_index,
                    "eval_metric": log.eval_metric,
                    "mean_loss": log.mean_loss,
                    "sync_time_s": sync,
                    "n_arrived": log.n_arrived,
                }
            )
        if backend == "timeline" and rounds:
            sync_times = self._timeline_sync_times(
                per_round_profiles, per_round_bits
            )
            for entry, log, s in zip(rounds, self.server.history[-len(
                    rounds):], sync_times):
                entry["sync_time_s"] = float(s)
                log.sync_time_s = float(s)
            total_time = float(sync_times.sum())
            sync = float(sync_times[-1])
        return CoSimResult(
            rounds=rounds,
            total_time_s=total_time,
            sync_time_s=sync,
            policy=self.cfg.policy,
            load=self.cfg.total_load,
        )
