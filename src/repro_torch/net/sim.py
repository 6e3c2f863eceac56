"""PON round types and the cycle-by-cycle round simulator.

Topology (paper §3): one OLT/CPS and ``n_onus`` ONU/EC nodes, 10 Gbps
symmetric, 20 km reach, 1 ms polling cycle, ~92% payload efficiency.
Background Poisson traffic rides assured T-CONTs both ways; the FL
task's traffic is:

* downstream: the global model, one unicast copy per client queued as
  best-effort behind background under FCFS; under BS one reserved
  broadcast (the PON downstream is a broadcast medium);
* upstream: each client's ``M_i^UD`` update, queued when its local
  training ends (FCFS) or sent in its slice slot (BS).

The round's synchronisation time is ``max_i upload_done_i + T_a``.
:func:`simulate_round` runs one round on the batched engine
(``net.engine``, ``backend="vectorized"`` or ``"jit"``) or on the
cycle-level oracle here (``backend="reference"``): ``OnuQueue`` FIFOs
and the DBAs of ``net.dba`` in Python floats, in the order of the JAX
package's ``repro.net.sim``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.scheduler import schedule_slots
from repro_torch.core.slicing import (
    LIGHT_SPEED_FIBER,
    ClientProfile,
    SliceSpec,
    compute_slice,
)
from repro_torch.net.dba import (
    DEFAULT_EFFICIENCY,
    FCFSBestEffort,
    OnuQueue,
    SlicedDBA,
)
from repro_torch.net.traffic import PoissonSource, background_rate_for_load

EPS_BITS = 1.0                   # a client is done below 1 remaining bit


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


def _bg_push(queues, sources, t, cycle):
    for q, src in zip(queues, sources):
        q.push("bg", src.arrivals(cycle), t)


def _mk_sources(cfg: PONConfig, bg_rate_bps: float,
                rng) -> List[PoissonSource]:
    per_onu = bg_rate_bps / cfg.n_onus
    return [
        PoissonSource(per_onu, rng, burst_packets=cfg.bg_burst_packets)
        for _ in range(cfg.n_onus)
    ]


def _credit(served, remaining, done, t, cfg):
    """Credit served FL bits to the clients that own them: FL segments
    are tagged ``("fl", client_id)``, so a client is done exactly when
    its own queued bits have crossed the wire."""
    for kind, bits in served.items():
        if not isinstance(kind, tuple):
            continue
        cid = kind[1]
        if cid not in remaining:
            continue
        remaining[cid] -= bits
        if remaining[cid] <= EPS_BITS:
            done[cid] = t + cfg.cycle_time_s + cfg.propagation_s
            del remaining[cid]


def _downstream_phase(cfg: PONConfig, workload: FLRoundWorkload,
                      bg_rate_bps: float, rng: np.random.Generator,
                      reserved: bool, max_t: float = 600.0, sources=None,
                      skip_ids=frozenset()) -> Dict[int, float]:
    """Model distribution; per-client download-done time. ``skip_ids``
    (deadline carriers resuming an upload) take no download (time 0)."""
    clients = workload.clients
    if reserved:
        # BS: one reserved broadcast at the effective line rate
        t = (workload.model_bits / (cfg.line_rate_bps * cfg.efficiency)
             + cfg.propagation_s)
        return {c.client_id: 0.0 if c.client_id in skip_ids else t
                for c in clients}

    queues = [OnuQueue(i) for i in range(cfg.n_onus)]
    qmap = {q.onu_id: q for q in queues}
    fresh = [c for c in clients if c.client_id not in skip_ids]
    for c in fresh:     # per-EC-node unicast copies queue at round start
        qmap[c.client_id % cfg.n_onus].push(
            ("fl", c.client_id), workload.model_bits, 0.0
        )
    if sources is None:
        sources = _mk_sources(cfg, bg_rate_bps, rng)
    dba = FCFSBestEffort(cfg.line_rate_bps, cfg.cycle_time_s, cfg.n_onus,
                         cfg.efficiency)
    remaining = {c.client_id: workload.model_bits for c in fresh}
    done: Dict[int, float] = {c.client_id: 0.0 for c in clients
                              if c.client_id in skip_ids}
    t = 0.0
    while remaining and t < max_t:
        _bg_push(queues, sources, t, cfg.cycle_time_s)
        for onu_id, g in dba.grant(queues).items():
            q = qmap[onu_id]
            if "bg" in g:
                q.serve(g["bg"], kind="bg")
            if "fl" in g:
                served = q.serve(g["fl"], kind="fl")
                _credit(served, remaining, done, t, cfg)
        t += cfg.cycle_time_s      # a running sum, as the reference's
    for cid in list(remaining):
        done[cid] = t + cfg.propagation_s
    return done


def _upstream_phase(cfg: PONConfig, workload: FLRoundWorkload,
                    ready: Dict[int, float], bg_rate_bps: float,
                    rng: np.random.Generator, dba_mode: str,
                    slice_spec: Optional[SliceSpec] = None, slots=None,
                    max_t: float = 600.0, sources=None,
                    deadline_s: Optional[float] = None,
                    outage_s: Optional[Tuple[float, float]] = None,
                    ) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Upload phase: (per-client upload-done time, bits still queued at
    the cutoff). ``deadline_s`` stops the phase at the round deadline,
    the unfinished clients' bits reported and their times NaN.
    ``outage_s`` (``(start, end)`` seconds into the phase) darkens the
    link: cycles starting inside it grant nothing while arrivals still
    queue (``start <= t < end`` on the cycle-start clock, the engine's
    rule)."""
    if deadline_s is not None:
        max_t = deadline_s
    o_start, o_end = outage_s if outage_s is not None else (np.inf, np.inf)
    clients = workload.clients
    queues = [OnuQueue(i) for i in range(cfg.n_onus)]
    qmap = {q.onu_id: q for q in queues}
    if sources is None:
        sources = _mk_sources(cfg, bg_rate_bps, rng)
    if dba_mode == "bs":
        dba = SlicedDBA(cfg.line_rate_bps, cfg.cycle_time_s, cfg.n_onus,
                        slice_spec.bandwidth_bps, slots, cfg.efficiency)
    else:
        dba = FCFSBestEffort(cfg.line_rate_bps, cfg.cycle_time_s,
                             cfg.n_onus, cfg.efficiency)

    remaining = {c.client_id: c.m_ud_bits for c in clients}
    pending = dict(ready)
    done: Dict[int, float] = {}
    t = 0.0
    while remaining and t < max_t:
        for cid, t_ready in list(pending.items()):
            if t_ready <= t + cfg.cycle_time_s:
                qmap[cid % cfg.n_onus].push(
                    ("fl", cid), remaining[cid], max(t_ready, t)
                )
                del pending[cid]
        _bg_push(queues, sources, t, cfg.cycle_time_s)
        if o_start <= t < o_end:
            t += cfg.cycle_time_s
            continue                # link dark: no grants this cycle
        grants = (dba.grant(queues, t) if dba_mode == "bs"
                  else dba.grant(queues))
        for onu_id, g in grants.items():
            q = qmap[onu_id]
            if "bg" in g:
                q.serve(g["bg"], kind="bg")
            if "fl" in g:
                served = q.serve(g["fl"], kind="fl")
                _credit(served, remaining, done, t, cfg)
        t += cfg.cycle_time_s
    if deadline_s is None:
        for cid in list(remaining):
            done[cid] = t + cfg.propagation_s
        remaining = {}
    else:
        for cid in remaining:
            done[cid] = float("nan")
    return done, dict(remaining)


def simulate_round(cfg: PONConfig, workload: FLRoundWorkload,
                   total_load: float, policy: str, seed: int = 0,
                   t_round_hint: float = 10.0,
                   backend: str = "vectorized", _dl_sources=None,
                   _ul_sources=None, ul_deadline_s: Optional[float] = None,
                   ul_outage_s=None, no_dl_ids=frozenset(),
                   stream_round: int = 0, topology=None, *,
                   device=DEFAULT_DEVICE) -> RoundResult:
    """Simulate one synchronisation round under ``policy`` in {fcfs, bs}.

    ``backend="vectorized"`` (default) runs the round on the batched
    engine (``net.engine``, the per-cycle loop: K1 and K2 on a card);
    ``"jit"`` runs each phase as one launch of the fused phase kernel;
    ``"reference"`` runs the cycle-by-cycle simulator on the host. The
    reference draws its own seeded numpy arrivals unless
    ``_dl_sources``/``_ul_sources`` inject per-ONU sources (which force
    the reference backend): :meth:`CounterStream.source` replays the
    engine's own counter-based arrivals.

    ``ul_deadline_s`` cuts the upload at a round deadline (unfinished
    bits in ``RoundResult.ul_remaining``); ``ul_outage_s`` (``(start,
    end)`` seconds, or ``(n_pons, 2)`` under a topology) darkens the
    upstream in an outage window; ``no_dl_ids`` are deadline carriers
    that skip the download; ``stream_round`` keys the engine's arrival
    stream for a timeline round. ``topology``
    (``net.multi_pon.MultiPonTopology``) stacks the round over several
    PONs sharing a CPS uplink; the reference backend then runs the
    multi-PON oracle (``simulate_multi_pon_round``), which draws the
    engine's counter streams and takes no injected sources. Engines and
    counter streams run on ``device``.
    """
    device = resolve_device(device)
    if backend not in ("vectorized", "reference", "jit"):
        raise ValueError(f"unknown backend {backend!r}")
    if (backend in ("vectorized", "jit") and _dl_sources is None
            and _ul_sources is None):
        from repro_torch.net.engine import SweepCase, _round_sweep

        return _round_sweep(
            cfg,
            [SweepCase(workload=workload, load=total_load, policy=policy,
                       seed=seed, stream_round=stream_round,
                       no_dl_ids=frozenset(no_dl_ids),
                       topology=topology)],
            t_round_hint=t_round_hint,
            ul_deadline_s=ul_deadline_s,
            ul_outage_s=None if ul_outage_s is None else [ul_outage_s],
            backend="jit" if backend == "jit" else None,
            device=device,
        )[0]
    if backend == "jit":
        raise ValueError(
            "backend='jit' cannot replay injected per-ONU sources; "
            "use backend='vectorized' or 'reference'"
        )
    if topology is not None and not topology.trivial:
        from repro_torch.net.multi_pon import simulate_multi_pon_round

        if _dl_sources is not None or _ul_sources is not None:
            raise ValueError(
                "multi-PON reference rounds draw from counter streams; "
                "injected per-ONU sources are single-PON only"
            )
        return simulate_multi_pon_round(
            cfg, topology, workload, total_load, policy, seed=seed,
            t_round_hint=t_round_hint, ul_deadline_s=ul_deadline_s,
            ul_outage_s=ul_outage_s, no_dl_ids=frozenset(no_dl_ids),
            stream_round=stream_round, device=device,
        )

    rng = np.random.default_rng(seed)
    clients = workload.clients
    n = len(clients)
    # the training traffic's own average rate is part of the offered load
    training_rate = (
        n * (workload.model_bits
             + float(np.mean([c.m_ud_bits for c in clients])))
        / max(t_round_hint, 1e-9)
    )
    bg_rate = background_rate_for_load(total_load, cfg.line_rate_bps,
                                       training_rate)

    if ul_outage_s is not None:
        win = np.asarray(ul_outage_s, np.float64).reshape(-1)
        if win.size != 2:
            raise ValueError(
                "single-PON ul_outage_s must be one (start, end) window"
            )
        ul_outage_s = (float(win[0]), float(win[1]))

    dl_done = _downstream_phase(
        cfg, workload, bg_rate, rng, reserved=(policy == "bs"),
        sources=_dl_sources, skip_ids=frozenset(no_dl_ids),
    )
    ready = {c.client_id: dl_done[c.client_id] + c.t_ud for c in clients}
    spec = slots = None
    if policy == "bs":
        # the OLT computes the slice from Φ at membership time; slice
        # times are relative to the round start (a single round, h·T = 0)
        profiles = [
            ClientProfile(client_id=c.client_id, t_ud=c.t_ud,
                          t_dl=dl_done[c.client_id], m_ud_bits=c.m_ud_bits,
                          distance_m=c.distance_m)
            for c in clients
        ]
        spec = compute_slice(
            profiles, t_current=0.0, t_round=0.0,
            capacity_bps=cfg.line_rate_bps * cfg.efficiency, h=1,
        )
        slots = schedule_slots(profiles, spec, round_start=0.0)
        ul_done, ul_remaining = _upstream_phase(
            cfg, workload, ready, bg_rate, rng, "bs", spec, slots,
            sources=_ul_sources, deadline_s=ul_deadline_s,
            outage_s=ul_outage_s,
        )
    else:
        ul_done, ul_remaining = _upstream_phase(
            cfg, workload, ready, bg_rate, rng, "fcfs",
            sources=_ul_sources, deadline_s=ul_deadline_s,
            outage_s=ul_outage_s,
        )

    if ul_remaining and ul_deadline_s is not None:
        sync = ul_deadline_s + workload.t_aggregate
    else:
        sync = max(ul_done.values()) + workload.t_aggregate
    return RoundResult(
        policy=policy,
        sync_time=sync,
        dl_done=dl_done,
        ready=ready,
        ul_done=ul_done,
        compute_bound=max(ready.values()),
        load=total_load,
        slice_spec=spec,
        ul_remaining=ul_remaining if ul_deadline_s is not None else None,
    )
