"""Multi-PON (wavelength-stacked) topology sharing one CPS uplink.

``n_pons`` wavelength/OLT segments, each a full TDM-PON with its own
cycle capacity and DBA, converge on a CPS link. Per polling cycle the
CPS capacity is waterfilled across the PONs (max-min fair,
:func:`cps_waterfill`, shared with ``kernels/ponsim``; its cap is a
float, or one per row as the tenant jobs' fairness split passes it). Client
``i`` lives on global ONU ``i % (n_pons * cfg.n_onus)``: PON
``onu // cfg.n_onus``, local ONU ``onu % cfg.n_onus``.

:func:`simulate_multi_pon_round` is the cycle-level oracle the stacked
engine is held to (rtol 1e-6): a per-PON cycle loop over ``OnuQueue``
state with a CPS post-pass between the PONs' raw DBA grants and the
serve step, on the engine's own counter streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, FLOAT, resolve_device
from repro_torch.core.scheduler import schedule_slots
from repro_torch.core.slicing import ClientProfile, compute_slice
from repro_torch.kernels.ponsim.ref import (  # noqa: F401 (re-export)
    cps_waterfill_ref as cps_waterfill,
)
from repro_torch.net.dba import FCFSBestEffort, OnuQueue, SlicedDBA
from repro_torch.net.traffic import (
    background_rate_for_load,
    counter_streams_for_pons,
)


@dataclass(frozen=True)
class MultiPonTopology:
    """Several OLT/wavelength segments sharing a CPS uplink.

    ``cps_rate_bps`` is the shared CPS link (``None`` = uncontended);
    its cycle capacity is ``rate * cycle_time`` with no PON framing.
    ``pon_rates_bps`` overrides each PON's line rate.
    """

    n_pons: int = 1
    cps_rate_bps: Optional[float] = None
    pon_rates_bps: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.n_pons < 1:
            raise ValueError("n_pons must be >= 1")
        if self.cps_rate_bps is not None and self.cps_rate_bps <= 0:
            raise ValueError("cps_rate_bps must be positive")
        if self.pon_rates_bps is not None:
            rates = tuple(float(r) for r in self.pon_rates_bps)
            if len(rates) != self.n_pons:
                raise ValueError(
                    f"pon_rates_bps needs {self.n_pons} entries; "
                    f"got {len(rates)}"
                )
            object.__setattr__(self, "pon_rates_bps", rates)

    @property
    def trivial(self) -> bool:
        """True when the topology adds nothing over a lone PONConfig."""
        return (self.n_pons == 1 and self.cps_rate_bps is None
                and self.pon_rates_bps is None)

    def rates(self, cfg) -> np.ndarray:
        if self.pon_rates_bps is not None:
            return np.asarray(self.pon_rates_bps, np.float64)
        return np.full(self.n_pons, cfg.line_rate_bps, np.float64)

    def capacity_bits(self, cfg) -> np.ndarray:
        """Per-PON cycle capacity ``(n_pons,)`` (payload bits)."""
        return self.rates(cfg) * cfg.cycle_time_s * cfg.efficiency

    def cps_capacity_bits(self, cfg) -> Optional[float]:
        if self.cps_rate_bps is None:
            return None
        return float(self.cps_rate_bps) * cfg.cycle_time_s

    def total_onus(self, cfg) -> int:
        return self.n_pons * cfg.n_onus

    def pon_of(self, client_id: int, cfg) -> int:
        return (int(client_id) % self.total_onus(cfg)) // cfg.n_onus

    def local_onu(self, client_id: int, cfg) -> int:
        return (int(client_id) % self.total_onus(cfg)) % cfg.n_onus


def pon_bg_rates(clients: Sequence[ClientProfile], model_bits: float,
                 total_load: float, cfg, topo: MultiPonTopology,
                 t_round_hint: float = 10.0,
                 model_bits_by_client=None) -> np.ndarray:
    """Per-ONU background rate ``(n_pons,)`` of each wavelength segment:
    what makes up ``total_load`` on that PON beside the training traffic
    of the clients placed on it. ``model_bits_by_client`` (tenant jobs)
    prices each client's download at its own job's model size; ``None``
    keeps the single-job arithmetic."""
    rates = topo.rates(cfg)
    total = topo.total_onus(cfg)
    out = np.zeros(topo.n_pons)
    for p in range(topo.n_pons):
        cl = [c for c in clients
              if (c.client_id % total) // cfg.n_onus == p]
        if not cl:
            training_rate = 0.0
        elif model_bits_by_client is not None:
            training_rate = sum(
                model_bits_by_client[c.client_id] + c.m_ud_bits
                for c in cl
            ) / max(t_round_hint, 1e-9)
        else:
            training_rate = (
                len(cl)
                * (model_bits + float(np.mean([c.m_ud_bits for c in cl])))
                / max(t_round_hint, 1e-9)
            )
        out[p] = background_rate_for_load(
            total_load, float(rates[p]), training_rate
        ) / cfg.n_onus
    return out


def host_waterfill(want: np.ndarray, cap) -> np.ndarray:
    """:func:`cps_waterfill` of one ``(P,)`` numpy vector, on the host."""
    return cps_waterfill(torch.as_tensor(want, dtype=FLOAT)[None, :],
                         cap)[0].numpy()


# ---------------------------------------------------------------------------
# cycle-level oracle: per-PON cycle loop + CPS post-pass
# ---------------------------------------------------------------------------


def _grant_total(grants: Dict[int, Dict[str, float]]) -> float:
    return sum(b for kinds in grants.values() for b in kinds.values())


def simulate_multi_pon_round(cfg, topo: MultiPonTopology, workload,
                             total_load: float, policy: str, seed: int = 0,
                             t_round_hint: float = 10.0,
                             max_t: float = 600.0,
                             ul_deadline_s: Optional[float] = None,
                             ul_outage_s: Optional[np.ndarray] = None,
                             no_dl_ids=frozenset(), stream_round: int = 0,
                             collector=None, *, device=DEFAULT_DEVICE):
    """One round on the cycle-by-cycle multi-PON oracle.

    Each cycle each PON's raw DBA grants are computed under its own
    wavelength capacity; the CPS post-pass waterfills the shared
    capacity across the PONs' grant totals, and a PON cut below its
    raw total re-grants under its share (``grant(..., cap_bits=eff_p)``).
    Background arrivals come from the engine's counter streams, keyed
    ``(seed, phase, stream_round, pon)`` and drawn on ``device`` (K1 on
    a card); everything else (FIFO queues, credit, deadlines, carriers
    that skip the download) is ``net.sim``'s.

    ``ul_outage_s`` (``(n_pons, 2)`` ``[start, end)`` windows, or
    ``(2,)`` for every PON; ``inf`` = never) darkens a PON's upstream:
    its raw grant is empty, so the waterfill sees no demand from it,
    while arrivals still queue. ``collector`` (``repro_torch.obs``)
    records the waterfill's per-PON want and granted bits
    (``multi_pon.cps_want_bits``, ``multi_pon.cps_eff_bits``), the CPS
    uplink's use each cycle (``multi_pon.cps_util``) and the upload
    times; ``None`` leaves the result bitwise unchanged.
    """
    from repro_torch.net.sim import RoundResult, _credit

    device = resolve_device(device)
    if policy not in ("fcfs", "bs"):
        raise ValueError(f"unknown policy {policy!r}")
    P = topo.n_pons
    n_local = cfg.n_onus
    total = topo.total_onus(cfg)
    clients = workload.clients
    if policy == "bs":
        bad = [c.client_id for c in clients if c.client_id >= total]
        if bad:
            raise ValueError(
                f"bs policy requires client_id < n_onus * n_pons; got {bad}"
            )
    pon_of = {c.client_id: topo.pon_of(c.client_id, cfg) for c in clients}
    onu_of = {c.client_id: topo.local_onu(c.client_id, cfg)
              for c in clients}
    rates = topo.rates(cfg)
    cps_cap = topo.cps_capacity_bits(cfg)
    per_onu = pon_bg_rates(clients, workload.model_bits, total_load,
                           cfg, topo, t_round_hint)
    cyc = cfg.cycle_time_s
    prop = cfg.propagation_s
    skip = frozenset(no_dl_ids)
    if ul_outage_s is not None:
        outage = np.asarray(ul_outage_s, np.float64)
        if outage.shape == (2,):
            outage = np.broadcast_to(outage, (P, 2))
        if outage.shape != (P, 2):
            raise ValueError(
                f"ul_outage_s must be (2,) or ({P}, 2); "
                f"got shape {outage.shape}"
            )
        if not np.isfinite(outage[:, 0]).any():
            outage = None
    else:
        outage = None

    def _cps_grants(raws, regrant):
        if cps_cap is None:
            return raws
        want = np.array([_grant_total(g) for g in raws])
        eff = host_waterfill(want, cps_cap)
        if collector is not None:
            collector.counter("multi_pon.cps_want_bits", (P,)).add(want)
            collector.counter("multi_pon.cps_eff_bits", (P,)).add(eff)
            collector.gauge("multi_pon.cps_util").observe(
                float(eff.sum()) / cps_cap
            )
        return [raws[p] if eff[p] >= want[p] else regrant(p, float(eff[p]))
                for p in range(P)]

    def _serve(qmaps, grants_all, remaining, done, t):
        for p in range(P):
            for onu_id, g in grants_all[p].items():
                q = qmaps[p][onu_id]
                if "bg" in g:
                    q.serve(g["bg"], kind="bg")
                if "fl" in g:
                    served = q.serve(g["fl"], kind="fl")
                    _credit(served, remaining, done, t, cfg)

    def _dark(p: int, t: float, windows) -> bool:
        """PON ``p``'s upstream is in its outage window at cycle start
        ``t`` (the engine's capacity-mask comparison)."""
        return (windows is not None
                and windows[p, 0] <= t < windows[p, 1])

    def _finish(done, remaining, t, deadline):
        if deadline is None:
            for cid in list(remaining):
                done[cid] = t + prop
            return {}
        for cid in remaining:
            done[cid] = float("nan")
        return dict(remaining)

    def _fcfs_phase(bits0, ready, phase_idx, max_t_p, deadline,
                    windows=None):
        queues = [[OnuQueue(i) for i in range(n_local)] for _ in range(P)]
        dbas = [FCFSBestEffort(float(rates[p]), cyc, n_local,
                               cfg.efficiency) for p in range(P)]
        streams = counter_streams_for_pons(
            seed, phase_idx, per_onu, cyc, n_local,
            cfg.bg_burst_packets, round_index=stream_round, device=device,
        )
        sources = [[streams[p].source(i) for i in range(n_local)]
                   for p in range(P)]
        remaining = dict(bits0)
        pending = dict(ready)
        done: Dict[int, float] = {}
        t = 0.0
        while remaining and t < max_t_p:
            for cid, t_ready in list(pending.items()):
                if t_ready <= t + cyc:
                    queues[pon_of[cid]][onu_of[cid]].push(
                        ("fl", cid), remaining[cid], max(t_ready, t)
                    )
                    del pending[cid]
            for p in range(P):
                for q, src in zip(queues[p], sources[p]):
                    q.push("bg", src.arrivals(cyc), t)
            raws = [{} if _dark(p, t, windows)
                    else dbas[p].grant(queues[p]) for p in range(P)]
            grants_all = _cps_grants(
                raws, lambda p, e: dbas[p].grant(queues[p], cap_bits=e)
            )
            _serve(
                [{q.onu_id: q for q in queues[p]} for p in range(P)],
                grants_all, remaining, done, t,
            )
            t += cyc
        return done, _finish(done, remaining, t, deadline)

    def _bs_phase(bits0, ready, dl_done, max_t_p, deadline,
                  windows=None):
        # the slice is a reserved T-CONT end to end (PON slot and CPS
        # priority), so background never feeds back into FL service and
        # the BS phase simulates none, as the engine does. Queues carry
        # their global ONU id: SlicedDBA matches a slot's client_id to it
        queues = [[OnuQueue(p * n_local + i) for i in range(n_local)]
                  for p in range(P)]
        dbas: list = []
        specs: Dict[int, object] = {}
        for p in range(P):
            profs = [
                ClientProfile(
                    client_id=c.client_id, t_ud=c.t_ud,
                    t_dl=dl_done[c.client_id], m_ud_bits=c.m_ud_bits,
                    distance_m=c.distance_m,
                )
                for c in clients if pon_of[c.client_id] == p
            ]
            if not profs:
                dbas.append(None)
                continue
            spec = compute_slice(
                profs, t_current=0.0, t_round=0.0,
                capacity_bps=float(rates[p] * cfg.efficiency), h=1,
            )
            slots = schedule_slots(profs, spec, round_start=0.0)
            specs[p] = spec
            dbas.append(SlicedDBA(
                float(rates[p]), cyc, n_local, spec.bandwidth_bps,
                slots, cfg.efficiency,
            ))
        remaining = dict(bits0)
        pending = dict(ready)
        done: Dict[int, float] = {}
        t = 0.0
        while remaining and t < max_t_p:
            for cid, t_ready in list(pending.items()):
                if t_ready <= t + cyc:
                    queues[pon_of[cid]][onu_of[cid]].push(
                        ("fl", cid), remaining[cid], max(t_ready, t)
                    )
                    del pending[cid]
            raws = [dbas[p].grant(queues[p], t)
                    if dbas[p] and not _dark(p, t, windows) else {}
                    for p in range(P)]
            grants_all = _cps_grants(
                raws,
                lambda p, e: dbas[p].grant(queues[p], t, cap_bits=e),
            )
            _serve(
                [{q.onu_id: q for q in queues[p]} for p in range(P)],
                grants_all, remaining, done, t,
            )
            t += cyc
        return done, _finish(done, remaining, t, deadline), specs

    # ---- downstream ------------------------------------------------------
    fresh = [c for c in clients if c.client_id not in skip]
    if policy == "bs":
        dl_done = {
            c.client_id: (
                0.0 if c.client_id in skip
                else workload.model_bits
                / (rates[pon_of[c.client_id]] * cfg.efficiency) + prop
            )
            for c in clients
        }
    else:
        bits0 = {c.client_id: workload.model_bits for c in fresh}
        ready0 = {c.client_id: 0.0 for c in fresh}
        dl_done, _ = _fcfs_phase(bits0, ready0, 0, max_t, None)
        for c in clients:
            if c.client_id in skip:
                dl_done[c.client_id] = 0.0

    ready = {c.client_id: dl_done[c.client_id] + c.t_ud for c in clients}

    # ---- upstream --------------------------------------------------------
    ul_max_t = max_t if ul_deadline_s is None else ul_deadline_s
    bits_ul = {c.client_id: c.m_ud_bits for c in clients}
    specs: Dict[int, object] = {}
    if policy == "bs":
        ul_done, ul_remaining, specs = _bs_phase(
            bits_ul, dict(ready), dl_done, ul_max_t, ul_deadline_s,
            windows=outage,
        )
    else:
        ul_done, ul_remaining = _fcfs_phase(
            bits_ul, dict(ready), 1, ul_max_t, ul_deadline_s,
            windows=outage,
        )

    if ul_remaining and ul_deadline_s is not None:
        sync = ul_deadline_s + workload.t_aggregate
    else:
        sync = max(ul_done.values()) + workload.t_aggregate
    if collector is not None:
        collector.record_upload_times(policy, total_load,
                                      list(ul_done.values()))
    return RoundResult(
        policy=policy,
        sync_time=sync,
        dl_done=dl_done,
        ready=ready,
        ul_done=ul_done,
        compute_bound=max(ready.values()),
        load=total_load,
        slice_spec=specs.get(0) if P == 1 else None,
        ul_remaining=ul_remaining if ul_deadline_s is not None else None,
    )
