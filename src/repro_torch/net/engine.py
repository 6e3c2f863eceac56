"""Batched PON round engine on PyTorch tensors.

The port of ``repro.net.engine``: one polling cycle is a handful of
tensor operations over all ONUs at once, with a batch axis over sweep
cases and, under a ``MultiPonTopology``, over each case's wavelength
segments (rows are flattened ``(case, pon)`` pairs over per-PON ONU
columns, coupled each cycle by the CPS waterfill).

* Queue state is float64 on ``device``; the per-cycle loop
  (:func:`_run_phase`) runs there. Setup and result assembly (layout,
  slice and slot schedule, the ``RoundResult`` dicts) stay on the host
  in numpy, as in the reference.
* The FCFS DBA's "assured background oldest-first, then best-effort FL
  oldest-first" is the waterfill grant (Hopper kernel K2 on a card);
  background arrivals come from the counter-based sampler (kernel K1).
* Every sum whose order can change a bit is taken in the reference's
  order: waterfill prefixes sequentially inside K2, slot prefixes and
  multi-client ONU sums column by column. Row totals of grants go
  through ``torch.sum``: they add multiples of one ulp of the cycle
  capacity that stay below it, which is exact in any order.
* The clock ``t`` is a host float advanced by ``t += cyc``, exactly as
  the reference, so completion times carry the same rounding.
* The loop's branches (clients left, a hard waterfill row, FL grants
  given, a partially drained background queue) read the device, one
  host sync each; client readiness, deadlines, outages and slot
  activity are decided from host copies with no sync.

``backend="jit"`` runs each phase in one call instead
(``kernels.ponsim.ops.run_phase_device``: one launch of the phase
kernel on a card), with the arrival sampler inside it; a phase whose
background ring walk loses exactness there is re-run on the per-cycle
loop on the same device, and :data:`phase_fallbacks` counts the
re-runs.

Multi-tenant cases (``SweepCase.jobs``) add a job axis: every column
binds to its owning job, and each cycle's FL capacity is split across
the jobs by the case's fairness policy (``net.jobs.job_fair_split``)
before each job's grants: under FCFS one oldest-first waterfill (K2)
over every job's masked per-ONU backlog, under BS each job's slots
spending prefix room within its share. A sweep where every case has one
job runs the single-tenant path bit for bit. The phase kernel carries
no job axis, so a multi-job sweep with ``backend="jit"`` runs the
per-cycle loop on the same device, as the JAX package does; its K1 and
K2 launches are counted like any other.

Public API: ``SweepCase`` + ``simulate_round_sweep``; prefer building a
``repro_torch.net.SweepSpec`` and calling ``simulate(spec)``. Multi-round
timelines, fault injection included, run over this engine
(``repro_torch.net.timeline``).

``collector`` (``repro_torch.obs.Collector``) instruments the per-cycle
loop as the reference's does: each phase registers a ``PhaseStats`` and
hands it, every cycle, a copy of the backlog and grant rows (whose row
sums it takes in numpy's order when it folds, so utilisation bins match
the reference's bit for bit) and the CPS want/eff; nothing of it reads
the device before the report. The phase kernel carries no
instrumentation, so a collector with ``backend="jit"`` raises
``ValueError``, as in the reference. ``collector=None`` runs exactly the
uninstrumented loop.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

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
from repro_torch.core.slicing import ClientProfile, SliceSpec, compute_slice
from repro_torch.kernels.ponsim.ops import run_phase_device, waterfill_grants
from repro_torch.kernels.ponsim.ref import hard_rows
from repro_torch.kernels.traffic.ops import (
    make_stream_key,
    sample_arrival_bits,
)
from repro_torch.net.jobs import (
    FAIRNESS_POLICIES,
    compute_job_stats,
    job_fair_split,
    validate_case_jobs,
)
from repro_torch.net.multi_pon import (
    MultiPonTopology,
    cps_waterfill,
    pon_bg_rates,
)
from repro_torch.net.traffic import PACKET_BITS, burst_lambda
from repro_torch.obs.trace import maybe_span

CAP_EPS = 1e-9       # the DBAs' "capacity exhausted" threshold
SEG_EPS = 1.0        # segments under 1 bit are compacted
EPS_BITS = 1.0       # a client is done below 1 remaining bit
_IKEY_INF = np.iinfo(np.int64).max // 4

_BACKENDS = (None, "numpy", "jit")

phase_fallbacks = 0   # jit phases re-run on the per-cycle loop (inexact)


@dataclass(frozen=True)
class SweepCase:
    """One cell of a sweep: a workload under (policy, load, seed).

    ``dl_arrivals``/``ul_arrivals`` optionally inject a per-cycle
    background arrival matrix ``(n_cycles, n_pons * n_onus)`` (bits) for
    a phase; cycles beyond it see zero arrivals. Otherwise arrivals come
    from the counter-based stream keyed ``(seed, phase, stream_round,
    pon)``. ``no_dl_ids`` skip the model download (``dl_done`` 0.0).
    Every case of a sweep shares one ``topology`` (``None`` = a single
    PON).

    ``jobs`` (a tuple of ``net.jobs.JobSpec``) makes the case
    multi-tenant: the jobs partition ``workload.clients``, each job's
    download broadcasts its own ``model_bits``, and each cycle's FL
    capacity is split across jobs by ``fairness`` (``"maxmin"``,
    ``"weighted"`` or ``"deadline"``). A sweep where every case has one
    job runs the single-tenant path bit for bit and adds per-job stats.
    """

    workload: "FLRoundWorkload"  # noqa: F821
    load: float
    policy: str                  # "fcfs" | "bs"
    seed: int = 0
    dl_arrivals: Optional[np.ndarray] = None
    ul_arrivals: Optional[np.ndarray] = None
    stream_round: int = 0
    no_dl_ids: frozenset = frozenset()
    topology: Optional[MultiPonTopology] = None
    jobs: Optional[tuple] = None          # Tuple[JobSpec, ...]
    fairness: str = "maxmin"


# ---------------------------------------------------------------------------
# client layout (host numpy)
# ---------------------------------------------------------------------------


class _Layout:
    """Static slot layout shared by every row of a sweep.

    Rows are flattened ``(case, pon)`` pairs (case-major); columns are
    ``(local_onu, slot)`` pairs, ascending, where ONU ``o`` carries
    ``max_p |clients on (p, o)|`` slots, bound in ascending client id
    order (``cid_of[p, col]``; a column is dead — ``part`` False — in
    rows whose PON or case does not bind it).
    """

    def __init__(self, cases: Sequence[SweepCase], n_onus: int,
                 n_pons: int = 1):
        total = n_onus * n_pons
        ids = sorted(
            {c.client_id for case in cases for c in case.workload.clients}
        )
        if not ids:
            raise ValueError("sweep needs at least one client")
        buckets: Dict[tuple, List[int]] = {}
        for i in ids:
            o = i % total
            buckets.setdefault((o // n_onus, o % n_onus), []).append(i)
        slots = np.zeros(n_onus, np.int64)
        for (_, o), lst in buckets.items():
            slots[o] = max(slots[o], len(lst))
        self.onu = np.repeat(np.arange(n_onus, dtype=np.int64), slots)
        slot_off = np.zeros(n_onus + 1, np.int64)
        np.cumsum(slots, out=slot_off[1:])
        nU = self.n_clients = int(slot_off[-1])
        self.cid_of = np.full((n_pons, nU), -1, np.int64)
        colmap: Dict[int, int] = {}
        for (p, o), lst in buckets.items():
            for s, cid in enumerate(lst):
                col = int(slot_off[o]) + s
                self.cid_of[p, col] = cid
                colmap[cid] = col
        starts = [0] + [
            j for j in range(1, nU) if self.onu[j] != self.onu[j - 1]
        ]
        self.seg_starts = np.asarray(starts, np.int64)
        self.seg_onus = self.onu[self.seg_starts]
        self.seg_len = np.diff(np.append(self.seg_starts, nU))
        self.single = bool(self.seg_len.max() == 1)
        self.identity = self.single and nU == n_onus and bool(
            (self.onu == np.arange(n_onus)).all()
        )

        R = len(cases) * n_pons
        self.part = np.zeros((R, nU), bool)
        self.t_ud = np.zeros((R, nU))
        self.m_ud = np.zeros((R, nU))
        self.list_pos = np.zeros((R, nU), np.int64)
        for b, case in enumerate(cases):
            seen = set()
            for p, c in enumerate(case.workload.clients):
                if c.client_id in seen:
                    raise ValueError(
                        f"duplicate client_id {c.client_id} in case {b}"
                    )
                seen.add(c.client_id)
                o = c.client_id % total
                r = b * n_pons + o // n_onus
                j = colmap[c.client_id]
                self.part[r, j] = True
                self.t_ud[r, j] = c.t_ud
                self.m_ud[r, j] = c.m_ud_bits
                self.list_pos[r, j] = p

    def rows(self, sel: np.ndarray) -> "_Layout":
        """Row-sliced view for a sub-batch of rows (columns shared)."""
        sub = object.__new__(_Layout)
        sub.__dict__.update(self.__dict__)
        for name in ("part", "t_ud", "m_ud", "list_pos"):
            setattr(sub, name, getattr(self, name)[sel])
        return sub


# ---------------------------------------------------------------------------
# arrival streams
# ---------------------------------------------------------------------------

_CHUNK = 1024
_CHUNK_TARGET_CELLS = 1 << 22     # bound per-chunk sampler memory


class _CaseFixed:
    """Replays an injected ``(n_cycles, n_onus)`` arrival matrix."""

    def __init__(self, rows, n_onus: int, device):
        rows = np.asarray(rows, np.float64)
        if rows.ndim != 2 or rows.shape[1] != n_onus:
            raise ValueError(f"arrivals must be (n_cycles, {n_onus})")
        self.rows = torch.as_tensor(rows, device=device)
        self.n = n_onus

    def chunk(self, cycle0: int, length: int) -> torch.Tensor:
        out = torch.zeros((length, self.n), dtype=FLOAT,
                          device=self.rows.device)
        avail = self.rows[cycle0:cycle0 + length]
        out[: len(avail)] = avail
        return out


class _Stream:
    """Batched counter-based arrival rows, chunked and O(1)-seekable.

    Sampled cases (``(key, lam)`` pairs) are drawn in one sampler call
    per chunk; injected cases replay their fixed matrices.
    """

    def __init__(self, entries: List, n_onus: int, inv_burst: float,
                 packet_bits: float = PACKET_BITS, *, device):
        self.n = n_onus
        self.inv_burst = inv_burst
        self.packet_bits = packet_bits
        self.device = device
        self.fixed = [(i, e) for i, e in enumerate(entries)
                      if isinstance(e, _CaseFixed)]
        self.sampled = [(i, e) for i, e in enumerate(entries)
                        if not isinstance(e, _CaseFixed)]
        self.B = len(entries)
        if self.sampled:
            self.keys = np.stack([np.asarray(e[0], np.uint32)
                                  for _, e in self.sampled])
            self.lams = np.array([e[1] for _, e in self.sampled],
                                 np.float32)
            self.rows_sel = torch.as_tensor(
                [i for i, _ in self.sampled], device=device)
        self.chunk_len = int(np.clip(
            _CHUNK_TARGET_CELLS // max(self.B * n_onus, 1), 64, _CHUNK
        ))
        self._buf: Optional[torch.Tensor] = None
        self._base = 0

    def row(self, k: int) -> torch.Tensor:
        if self._buf is None or k >= self._base + self._buf.shape[1]:
            self._base = k
            draw = self.sampled and float(self.lams.max()) > 0.0
            if draw and not self.fixed:
                buf = sample_arrival_bits(
                    self.keys, k, self.chunk_len, self.n, self.lams,
                    self.inv_burst, self.packet_bits, device=self.device)
            else:
                buf = torch.zeros((self.B, self.chunk_len, self.n),
                                  dtype=FLOAT, device=self.device)
                if draw:
                    buf[self.rows_sel] = sample_arrival_bits(
                        self.keys, k, self.chunk_len, self.n, self.lams,
                        self.inv_burst, self.packet_bits,
                        device=self.device)
                for i, e in self.fixed:
                    buf[i] = e.chunk(k, self.chunk_len)
            self._buf = buf
        return self._buf[:, k - self._base, :]


# ---------------------------------------------------------------------------
# background queues: exact FIFO semantics over the arrival history
# ---------------------------------------------------------------------------


class _BgQueues:
    """Batched per-ONU background FIFOs on a chunked prefix-sum history.

    ``prefix[b, j, n]`` holds the cumulative bits pushed through cycle
    ``j``; a queue's state is its drained offset ``D``: backlog is
    ``cum - D``, the head-of-line segment is the first cycle whose
    prefix exceeds ``D``, and a partial grant advances ``D`` by the
    grant plus the reference's ≤1-bit compaction snap. History lives in
    ``_CHUNK``-cycle device tensors, dropped once every live head has
    passed them.
    """

    def __init__(self, B: int, n_onus: int, device):
        self.B, self.N = B, n_onus
        self.device = device
        z = dict(dtype=FLOAT, device=device)
        self.ptr = torch.zeros((B, n_onus), dtype=torch.int64,
                               device=device)        # head segment cycle
        self.drained = torch.zeros((B, n_onus), **z)  # incl. snap charges
        self.cum = torch.zeros((B, n_onus), **z)      # pushed through k
        self.backlog = torch.zeros((B, n_onus), **z)
        self._chunks: Dict[int, torch.Tensor] = {}

    def push(self, k: int, bits: torch.Tensor):
        cidx, off = divmod(k, _CHUNK)
        buf = self._chunks.get(cidx)
        if buf is None:
            buf = self._chunks[cidx] = torch.empty(
                (self.B, _CHUNK, self.N), dtype=FLOAT, device=self.device)
        fresh = (self.backlog <= 0.0) & (bits > 0.0)
        self.cum = self.cum + bits
        buf[:, off, :] = self.cum
        self.backlog = self.cum - self.drained
        # an arrival into an empty queue is the new head; every other
        # event keeps ptr exact
        self.ptr = torch.where(fresh, k, self.ptr)
        if k and off == 0:
            live = torch.where(self.backlog > 0.0, self.ptr, k)
            floor = int(live.min()) // _CHUNK
            for c in [c for c in self._chunks if c < floor]:
                del self._chunks[c]

    def _prefix_at(self, idx: torch.Tensor) -> torch.Tensor:
        """Prefix values at absolute cycle ``idx`` ``(B, N)`` (0 where no
        chunk holds the cycle)."""
        out = torch.zeros((self.B, self.N), dtype=FLOAT, device=self.device)
        for cidx, buf in self._chunks.items():
            base = cidx * _CHUNK
            m = (idx >= base) & (idx < base + _CHUNK)
            off = (idx - base).clamp(0, _CHUNK - 1)
            out = torch.where(m, buf.gather(1, off[:, None, :])[:, 0, :],
                              out)
        return out

    def _advance(self, active, ptr, target, k: int) -> torch.Tensor:
        """First cycle ≤ k whose prefix exceeds ``target``, for the
        ``active`` queues (beyond ``k`` when none does).

        A marginal queue usually crosses one or two segments, so a few
        single steps come first; queues still moving after them search
        their own history row (``torch.searchsorted``) in one call.
        """
        for _ in range(3):
            move = active & (ptr <= k) & (self._prefix_at(ptr) <= target)
            if not bool(move.any()):
                return ptr
            ptr = ptr + move
        rb, rn = torch.nonzero(move, as_tuple=True)
        first = min(self._chunks)
        hist = torch.cat([self._chunks[c][rb, :, rn]
                          for c in sorted(self._chunks)], dim=1)
        cycle = first * _CHUNK + torch.arange(hist.shape[1],
                                              device=self.device)
        hist = torch.where(cycle[None, :] < ptr[rb, rn][:, None],
                           -torch.inf, hist)
        hist = torch.where(cycle[None, :] > k, torch.inf, hist)
        pos = torch.searchsorted(hist, target[rb, rn][:, None],
                                 right=True)[:, 0]
        ptr[rb, rn] = first * _CHUNK + pos
        return ptr

    def hol_key(self) -> torch.Tensor:
        """FCFS sort key: the head segment's arrival cycle (ordering by
        ``ptr`` is ordering by head-of-line age)."""
        return torch.where(self.backlog > 0.0, self.ptr, _IKEY_INF)

    def serve(self, grants: torch.Tensor, k: int):
        # a grant equal to the whole backlog drains the queue exactly
        full = (grants > 0.0) & (grants == self.backlog)
        budget = torch.where(full, 0.0, grants)
        self.drained = torch.where(full, self.cum, self.drained)
        self.backlog = torch.where(full, 0.0, self.backlog)
        self.ptr = torch.where(full, k + 1, self.ptr)
        part = budget > CAP_EPS
        if not bool(part.any()):
            return
        # partial grants: closed-form drain on the prefix history (dense
        # over all queues, kept where ``part``)
        target = self.drained + budget
        ptr = self._advance(part, self.ptr, target, k)
        seg_end = self._prefix_at(ptr)
        in_hist = ptr <= k
        snap = in_hist & (seg_end - target <= SEG_EPS)
        drained = torch.where(snap, seg_end, target)
        bklg = torch.where(in_hist, self.cum - drained, 0.0)
        low = bklg < 0.5
        drained = torch.where(low, self.cum, drained)
        bklg = torch.where(low, 0.0, bklg)
        ptr = torch.where(low, k + 1, ptr)
        # a snap consumed through the segment at ptr; the new head is
        # the next arrival cycle (prefix > drained), not blindly ptr+1
        adv = part & snap & ~low
        ptr = torch.where(adv, self._advance(adv, ptr + 1, drained, k), ptr)
        self.drained = torch.where(part, drained, self.drained)
        self.ptr = torch.where(part, ptr, self.ptr)
        self.backlog = torch.where(part, bklg, self.backlog)


# ---------------------------------------------------------------------------
# per-cycle grants
# ---------------------------------------------------------------------------


def _waterfill(backlog: torch.Tensor, hol_fn, cap: torch.Tensor
               ) -> torch.Tensor:
    """Oldest-first ``take = min(backlog, cap)`` grants (kernel K2).

    ``hol_fn`` is called lazily: when every row's demand sits at least
    one bit under capacity each queue gets its full backlog whatever the
    age order, so head-of-line keys are never computed.
    """
    hard = hard_rows(backlog, cap)
    if not bool(hard.any()):
        return backlog.clone()
    return waterfill_grants(backlog, hol_fn(), cap, hard,
                            device=backlog.device)


class _FLQueues:
    """Batched per-ONU FL FIFOs over the static client layout."""

    def __init__(self, lay: _Layout, B: int, n_onus: int, device):
        self.lay = lay
        self.B, self.N = B, n_onus
        self.device = device
        nU = lay.n_clients
        self.qb = torch.zeros((B, nU), dtype=FLOAT, device=device)
        self.push_key = torch.full((B, nU), _IKEY_INF, dtype=torch.int64,
                                   device=device)
        self.push_time = torch.zeros((B, nU), dtype=FLOAT, device=device)
        self.list_pos = torch.as_tensor(lay.list_pos, device=device)
        self.single = lay.single
        self.onu = torch.as_tensor(lay.onu, device=device)
        self.seg_onus = torch.as_tensor(lay.seg_onus, device=device)
        if not self.single:
            # segment members padded to the longest ONU with a dummy
            # column nU, so per-ONU reductions are fixed-shape gathers
            L = int(lay.seg_len.max())
            idx = np.full((len(lay.seg_starts), L), nU, np.int64)
            for s, (a, n) in enumerate(zip(lay.seg_starts, lay.seg_len)):
                idx[s, :n] = np.arange(a, a + n)
            self.seg_idx = torch.as_tensor(idx, device=device)
            self.pos = torch.arange(nU, device=device)

    def push(self, mask, bits, k: int, t: float, ready_t):
        nU = self.lay.n_clients
        self.qb = torch.where(mask, bits, self.qb)
        key = k * (nU + 1) + self.list_pos
        self.push_key = torch.where(mask, key, self.push_key)
        self.push_time = torch.where(
            mask, torch.clamp(ready_t, min=t), self.push_time)

    def _segments(self, x: torch.Tensor, pad) -> torch.Tensor:
        """``(B, n_seg, L)`` members of each ONU segment, padded."""
        col = torch.full((self.B, 1), pad, dtype=x.dtype,
                         device=self.device)
        return torch.cat([x, col], dim=1)[:, self.seg_idx]

    def backlog_per_onu(self, mask=None) -> torch.Tensor:
        """Per-ONU FL backlog; ``mask`` (tenant jobs) restricts the sum
        to one job's columns. ``mask=None`` keeps the single-tenant
        tensors, the aliased identity view included."""
        if self.lay.identity:
            if mask is None:
                return self.qb  # aliased view: callers only read it
            return torch.where(mask, self.qb, 0.0)
        qb = self.qb if mask is None else torch.where(mask, self.qb, 0.0)
        out = torch.zeros((self.B, self.N), dtype=FLOAT,
                          device=self.device)
        if self.single:
            out[:, self.seg_onus] = qb
        else:
            # np.add.reduceat order: members added left to right
            seg = self._segments(qb, 0.0)
            acc = seg[:, :, 0]
            for j in range(1, seg.shape[2]):
                acc = acc + seg[:, :, j]
            out[:, self.seg_onus] = acc
        return out

    def _heads(self, mask=None):
        """``(has, pos)``: whether each ONU segment has a queued head and
        the column of its oldest pushed client (of ``mask``'s columns)."""
        nU = self.lay.n_clients
        nonzero = self.qb > 0.0
        if mask is not None:
            nonzero = nonzero & mask
        pk = torch.where(nonzero, self.push_key, 0)
        combined = torch.where(nonzero, pk * nU + self.pos, _IKEY_INF)
        m = self._segments(combined, _IKEY_INF).amin(dim=2)
        has = m < _IKEY_INF
        return has, torch.where(has, m % nU, 0)

    def hol_per_onu(self, mask=None) -> torch.Tensor:
        live = self.qb > 0.0
        if mask is not None:
            live = live & mask
        if self.lay.identity:
            return torch.where(live, self.push_time, torch.inf)
        out = torch.full((self.B, self.N), torch.inf, dtype=FLOAT,
                         device=self.device)
        if self.single:
            out[:, self.seg_onus] = torch.where(live, self.push_time,
                                                torch.inf)
            return out
        has, pos = self._heads(mask)
        out[:, self.seg_onus] = torch.where(
            has, torch.gather(self.push_time, 1, pos), torch.inf)
        return out

    def serve(self, grants_onu: torch.Tensor, backlog_onu: torch.Tensor,
              mask=None):
        """Drain FIFO heads per ONU, reproducing ``OnuQueue.serve``'s
        1-bit segment compaction (which also charges the grant). With
        ``mask`` (tenant jobs) the grant is one job's share and only that
        job's columns drain; ``backlog_onu`` is then the same-masked
        per-ONU backlog."""
        lay = self.lay
        if self.single:
            budget = (grants_onu if lay.identity
                      else grants_onu[:, self.onu])
            act = (budget > CAP_EPS) & (self.qb > 0.0)
            if mask is not None:
                act = act & mask
            take = torch.where(act, torch.minimum(budget, self.qb), 0.0)
            drop = act & (self.qb - take <= SEG_EPS)
            self.qb = torch.where(drop, 0.0, self.qb - take)
            return
        nU = lay.n_clients
        full = (grants_onu > 0.0) & (grants_onu == backlog_onu)
        zero = full[:, self.onu]
        if mask is not None:
            zero = zero & mask
        self.qb = torch.where(zero, 0.0, self.qb)
        budget = torch.where(full, 0.0, grants_onu)[:, self.seg_onus]
        while True:
            has, pos = self._heads(mask)
            srv = has & (budget > CAP_EPS)
            if not bool(srv.any()):
                break
            hq = torch.gather(self.qb, 1, pos)
            take = torch.where(srv, torch.minimum(budget, hq), 0.0)
            resid = torch.where(srv, hq - take, torch.inf)
            drop = srv & (resid <= SEG_EPS)
            newq = torch.where(drop, 0.0, hq - take)
            # served segments write their head; the rest write a dummy
            # column, so no two writes meet
            qb = torch.cat([self.qb, torch.zeros((self.B, 1), dtype=FLOAT,
                                                 device=self.device)], 1)
            qb.scatter_(1, torch.where(srv, pos, nU), newq)
            self.qb = qb[:, :nU]
            charge = torch.where(drop, resid, 0.0)
            budget = torch.clamp(budget - take - charge, min=0.0)


def _credit(rem, done, done_t, drained, t_done: float):
    """Attribute served FL bits to the clients that own them: a client
    is done when its queued update has fully crossed the wire."""
    new_rem = rem - drained
    newly = ~done & (drained > 0.0) & (new_rem <= EPS_BITS)
    rem = torch.where(newly, 0.0, torch.clamp(new_rem, min=0.0))
    done = done | newly
    done_t = torch.where(newly, t_done, done_t)
    return rem, done, done_t


class _Slots:
    """A BS phase's stacked slot arrays, on the host and the device.

    Slot activity in a cycle depends on the clock alone, so the host
    decides which slots can grant (and how wide a window each row needs)
    without reading the device.
    """

    def __init__(self, slot_arrays, cyc: float, device):
        ts, te, onu_idx, rate, valid = slot_arrays
        self.ts, self.valid = ts, valid
        self.te_g = te + cyc
        self.S = ts.shape[1]
        self.cols = np.arange(self.S)
        dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.d_ts, self.d_te_g, self.d_valid = dev(ts), dev(self.te_g), \
            dev(valid)
        self.d_onu, self.d_rate = dev(onu_idx), dev(rate)
        self.device = device

    def window(self, t: float, cyc: float):
        """Width of the widest row's run of active slots this cycle
        (0 when no slot is active)."""
        active = self.valid & (self.ts < t + cyc) & (self.te_g > t)
        if not active.any():
            return 0
        lo = np.where(active, self.cols, self.S).min(axis=1)
        hi = np.where(active, self.cols, -1).max(axis=1)
        return int((hi - lo).max()) + 1


def _slot_grants(slots: _Slots, backlog_onu, t: float, cyc: float,
                 cap, n_onus: int) -> torch.Tensor:
    """SlicedDBA slot grants: overlap * slice rate, capped by the FL
    backlog and the sequentially spent per-row cycle capacity ``cap``.

    Only each row's run of active slots is gathered: the slots outside
    it want exactly 0, so the slot-order prefix over the run equals the
    reference's prefix over every slot bit for bit.
    """
    B = backlog_onu.shape[0]
    W = slots.window(t, cyc)
    out = torch.zeros((B, n_onus), dtype=FLOAT, device=slots.device)
    if not W:
        return out
    t_end = t + cyc
    act = slots.d_valid & (slots.d_ts < t_end) & (slots.d_te_g > t)
    lo = torch.argmax(act.to(torch.int8), dim=1, keepdim=True)
    idx = lo + torch.arange(W, device=slots.device)
    inside = idx < slots.S
    idx = idx.clamp(max=slots.S - 1)
    ts = torch.gather(slots.d_ts, 1, idx)
    te_g = torch.gather(slots.d_te_g, 1, idx)
    onu = torch.gather(slots.d_onu, 1, idx)
    active = inside & torch.gather(act, 1, idx)
    overlap = torch.clamp(te_g, max=t_end) - torch.clamp(ts, min=t)
    want = slots.d_rate * torch.clamp(overlap, min=0.0)
    want = torch.minimum(want, torch.gather(backlog_onu, 1, onu))
    want = torch.where(active & (want > 0.0), want, 0.0)
    prefix = seq_cumsum(want)
    grants = torch.minimum(
        want, torch.clamp(cap[:, None] - (prefix - want), min=0.0))
    # distinct slots of a row sit on distinct ONUs: no two grants meet
    return out.scatter_add_(1, onu, grants)


class _JobSlots:
    """A tenant BS phase's stacked slot arrays (``_stack_slots_jobs``):
    per-slot rates and owning jobs, and each job's slots of a row in slot
    order (``run``, padded with the dummy column ``S``).

    A client has one slot and BS takes client ids below ``n_onus *
    n_pons``, so the slots of a row sit on distinct ONUs whatever jobs
    own them: their grants never meet in a scatter, and the reference's
    ``np.add.at`` order cannot matter.
    """

    def __init__(self, slot_arrays, cyc: float, n_jobs: int, device):
        ts, te, onu, rate, valid, sjob = slot_arrays
        B, S = ts.shape
        self.ts, self.valid = ts, valid
        self.te_g = te + cyc
        self.S = S
        runs = [[np.nonzero(valid[b] & (sjob[b] == j))[0]
                 for j in range(n_jobs)] for b in range(B)]
        L = max((len(c) for row in runs for c in row), default=0) or 1
        run = np.full((B, n_jobs, L), S, np.int64)
        for b, row in enumerate(runs):
            for j, cols in enumerate(row):
                run[b, j, :len(cols)] = cols
        dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.d_ts, self.d_te_g, self.d_valid = dev(ts), dev(self.te_g), \
            dev(valid)
        self.d_onu, self.d_rate, self.d_sjob = dev(onu), dev(rate), \
            dev(sjob)
        self.d_run = dev(run.reshape(B, -1))
        self.device = device

    def live(self, t: float, cyc: float) -> bool:
        """Whether any slot wants capacity this cycle: active ones, or
        expired ones (their best-effort tail)."""
        return bool((self.valid & ((self.ts < t + cyc)
                                   | (self.te_g <= t))).any())


def _job_demand(per_job: torch.Tensor) -> torch.Tensor:
    """``(B, J)`` row totals of ``per_job`` ``(J, B, n)``, each in
    ``np.sum``'s order."""
    J, B, n = per_job.shape
    return np_sum(per_job.reshape(J * B, n)).reshape(J, B).T


def _job_grants_fcfs(fl: _FLQueues, ctx, cap_fl, t: float):
    """Per-job FCFS grant plan: the FL residual capacity split across
    jobs by the fairness policy on each job's total backlog, then each
    job's share poured oldest-first over its own queues: one waterfill
    (K2) over rows ``(job, row)``, which are independent as the
    reference's one waterfill a job are.

    Returns ``(mask, grants_onu, backlog_onu)`` triples, one a job.
    """
    masks = ctx["masks"]
    bos = torch.stack([fl.backlog_per_onu(m) for m in masks])  # (J, B, N)
    J, B, N = bos.shape
    shares = job_fair_split(_job_demand(bos), cap_fl, ctx["fairness"],
                            weights=ctx["weights"],
                            slack=ctx["deadlines"] - t)
    grants = _waterfill(
        bos.reshape(J * B, N),
        lambda: torch.stack([fl.hol_per_onu(m) for m in masks]
                            ).reshape(J * B, N),
        shares.T.reshape(J * B)).reshape(J, B, N)
    return [(m, grants[j], bos[j]) for j, m in enumerate(masks)]


def _job_grants_bs(slots: _JobSlots, fl: _FLQueues, ctx, t: float,
                   cyc: float, cap, n_onus: int, cps_cap: Optional[float],
                   n_pons: int):
    """Per-job SlicedDBA grant plan.

    Slot wants are ``_slot_grants``' (overlap * slice rate, capped by
    the owning job's backlog at the slot's ONU), with a best-effort
    tail: an expired slot keeps asking for its slice rate, so backlog
    that inter-job fairness or the CPS re-cap left behind drains. The
    wants add up to per-``(row, job)`` demand for the fairness split
    (re-capped by the CPS waterfill over each case's flattened
    ``(pon, job)`` shares when a CPS rate binds), and each job's slots
    then spend prefix room within the job's share.
    """
    masks = ctx["masks"]
    J = len(masks)
    bos = torch.stack([fl.backlog_per_onu(m) for m in masks])  # (J, B, N)
    B = bos.shape[1]
    if not slots.live(t, cyc):
        zero = torch.zeros((B, n_onus), dtype=FLOAT, device=slots.device)
        return [(m, zero, bos[j]) for j, m in enumerate(masks)]
    t_end = t + cyc
    active = slots.d_valid & (slots.d_ts < t_end) & (slots.d_te_g > t)
    tail = slots.d_valid & (slots.d_te_g <= t)
    overlap = (torch.clamp(slots.d_te_g, max=t_end)
               - torch.clamp(slots.d_ts, min=t))
    want = torch.where(
        active, slots.d_rate * torch.clamp(overlap, min=0.0),
        torch.where(tail, slots.d_rate * cyc, 0.0))
    bidx = torch.arange(B, device=slots.device)[:, None]
    want = torch.minimum(want, bos[slots.d_sjob, bidx, slots.d_onu])
    want = torch.where(want > 0.0, want, 0.0)
    jobs = torch.arange(J, device=slots.device)[:, None, None]
    shares = job_fair_split(
        _job_demand(torch.where(slots.d_sjob[None] == jobs, want[None],
                                0.0)),
        cap, ctx["fairness"], weights=ctx["weights"],
        slack=ctx["deadlines"] - t)
    if cps_cap is not None:
        # the (case, pon, job) waterfill: a case's rows are its n_pons
        # consecutive rows, so its P*J shares form one waterfill row
        shares = cps_waterfill(shares.reshape(-1, n_pons * J),
                               cps_cap).reshape(B, J)
    # each job's prefix over its own slots, in slot order (the other
    # jobs' slots add zeros to it in the reference)
    padded = torch.cat([want, torch.zeros((B, 1), dtype=FLOAT,
                                          device=slots.device)], 1)
    run = torch.gather(padded, 1, slots.d_run)
    prefix = torch.zeros_like(padded).scatter_(
        1, slots.d_run, seq_cumsum(run.reshape(B * J, -1)).reshape(B, -1)
    )[:, :slots.S]
    room = torch.gather(shares, 1, slots.d_sjob) - (prefix - want)
    grants = torch.minimum(want, torch.clamp(room, min=0.0))
    # padding slots (job 0, ONU 0) add exact zeros
    out = torch.zeros((J * B * n_onus,), dtype=FLOAT, device=slots.device)
    flat = ((slots.d_sjob * B + bidx) * n_onus + slots.d_onu).reshape(-1)
    out = out.scatter_add_(0, flat, grants.reshape(-1)).reshape(J, B, n_onus)
    return [(m, out[j], bos[j]) for j, m in enumerate(masks)]


# ---------------------------------------------------------------------------
# phase runner
# ---------------------------------------------------------------------------

_OBS_ROWS = ("bg_backlog", "fl_backlog", "bg_grants", "fl_grants")


def _observe_cycle(obs, cap, cps_want=None, cps_eff=None, **rows) -> None:
    """Hand ``obs`` (a ``PhaseStats``) one cycle: the ``(B, N)`` backlogs
    and grants in ``rows`` (None where the cycle has none) stacked into
    one fresh tensor (one copy; their row sums are taken when ``obs``
    folds) and the ``(B,)`` CPS want/eff, fresh tensors. ``cap`` is never
    written, so nothing buffered is a tensor the loop later changes."""
    names = [name for name in _OBS_ROWS if rows.get(name) is not None]
    if names:
        obs.cycle_rows(cap, torch.cat([rows[name] for name in names]),
                       names, cps_want=cps_want, cps_eff=cps_eff)
    else:
        obs.cycle(cap, cps_want=cps_want, cps_eff=cps_eff)


def _run_phase(cfg, lay: _Layout, rem_init: np.ndarray,
               ready_t: np.ndarray, stream: Optional[_Stream], mode: str,
               slot_arrays=None, max_t: float = 600.0,
               fill_unfinished: bool = True,
               cap_row: Optional[np.ndarray] = None,
               cps_cap: Optional[float] = None, n_pons: int = 1,
               deadline_row: Optional[np.ndarray] = None,
               outage_row: Optional[np.ndarray] = None, jobs_ctx=None,
               collector=None, phase_label: str = "", *, device):
    """One transfer phase for a policy-homogeneous batch of rows.

    Host numpy in and out; the cycle loop runs on ``device``. Rows are
    ``(case, pon)`` pairs; ``cap_row`` is each row's cycle capacity and
    ``cps_cap`` the CPS budget shared by a case's ``n_pons`` rows.
    Returns ``(done_t, rem)``: per-client completion times (NaN for
    clients outside a case) and the bits still unserved. Clients cut off
    at ``max_t`` get ``t + propagation`` when ``fill_unfinished``.
    ``deadline_row`` ``(B,)`` gives each row its own cutoff (``inf`` =
    none); ``outage_row`` ``(B, 2)`` masks a row's capacity to zero for
    cycles starting in ``[start, end)``. ``jobs_ctx`` (multi-tenant
    sweeps: each job's column mask, the rows' job weights and deadlines,
    the fairness policy) splits each cycle's FL capacity across jobs
    before the grants, and each job drains only its own queues.
    ``collector`` registers a ``PhaseStats`` under ``phase_label`` (by
    default ``mode``) and feeds it every cycle (:func:`_observe_cycle`).
    """
    B = rem_init.shape[0]
    N = cfg.n_onus
    cyc = cfg.cycle_time_s
    prop = cfg.propagation_s
    if cap_row is None:
        cap_row = np.full((B,), cfg.line_rate_bps * cyc * cfg.efficiency)
    cap_row = np.asarray(cap_row, np.float64)
    if deadline_row is None:
        cap_t = None
        tmax = max_t
    else:
        cap_t = np.where(np.isfinite(deadline_row), deadline_row, max_t)
        tmax = float(cap_t.max())

    def dev(a):
        return torch.as_tensor(a, device=device)

    part = dev(lay.part)
    rem = dev(np.asarray(rem_init, np.float64))
    done_h = ~lay.part | (rem_init <= 0.0)
    done = dev(done_h)
    done_t = torch.full(rem.shape, torch.nan, dtype=FLOAT, device=device)
    ready_d = dev(np.asarray(ready_t, np.float64))
    fl = _FLQueues(lay, B, N, device)
    # under the Sliced DBA the FL slice is served first and background
    # only gets the residual: the BS phase needs no background at all
    use_bg = mode == "fcfs"
    bg = _BgQueues(B, N, device) if use_bg else None
    if slot_arrays is None:
        slots = None
    elif jobs_ctx is None:
        slots = _Slots(slot_arrays, cyc, device)
    else:
        slots = _JobSlots(slot_arrays, cyc, len(jobs_ctx["masks"]), device)

    obs = None
    if collector is not None:
        obs = collector.phase(phase_label or mode, B, device=device)

    n_left = int(np.count_nonzero(~done_h & lay.part))
    waiting = lay.part & ~done_h          # host: readiness needs no device
    n_wait = int(np.count_nonzero(waiting))
    t = 0.0
    k = 0
    cap_col = dev(cap_row)
    cap_cyc = cap_col
    masked = cap_t is not None or outage_row is not None
    dark_prev = np.zeros(B, bool)
    while t < tmax and n_left:
        if masked:
            # rows past their deadline or inside an outage get no
            # capacity; decided on the host clock, uploaded on change
            dark = np.zeros(B, bool)
            if cap_t is not None:
                alive = cap_t > t
                if not alive.all() and not bool(
                        (dev(alive)[:, None] & part & ~done).any()):
                    break
                dark |= ~alive
            if outage_row is not None:
                dark |= (outage_row[:, 0] <= t) & (t < outage_row[:, 1])
            if (dark != dark_prev).any():
                cap_cyc = dev(np.where(dark, 0.0, cap_row))
                dark_prev = dark
        if use_bg:
            bg.push(k, stream.row(k))
        if obs is not None:
            # this cycle's observations, at the reference's points
            ob_bg = ob_fl = ob_bg_g = ob_fl_g = ob_want = ob_eff = None
        if n_wait:
            newly = waiting & (ready_t <= t + cyc)
            n_new = int(np.count_nonzero(newly))
            if n_new:
                waiting &= ~newly
                n_wait -= n_new
                fl.push(dev(newly), rem, k, t, ready_d)

        # pushed & undone clients hold exactly the nonzero FL queues, so
        # the idle stretch before the first ready client skips FL work
        if n_left > n_wait:
            backlog_onu = fl.backlog_per_onu()
            if obs is not None:
                ob_fl = backlog_onu
                if use_bg:
                    ob_bg = bg.backlog
            plan = None
            if mode == "fcfs":
                if cps_cap is None:
                    eff = cap_cyc
                else:
                    want = torch.minimum(
                        bg.backlog.sum(dim=1) + backlog_onu.sum(dim=1),
                        cap_cyc)
                    eff = cps_waterfill(want.reshape(-1, n_pons),
                                        cps_cap).reshape(-1)
                    if obs is not None:
                        ob_want, ob_eff = want, eff
                bg_grants = _waterfill(bg.backlog, bg.hol_key, eff)
                if obs is not None:
                    ob_bg_g = bg_grants
                cap_fl = eff - bg_grants.sum(dim=1)
                if jobs_ctx is None:
                    fl_grants = _waterfill(backlog_onu, fl.hol_per_onu,
                                           cap_fl)
                else:
                    plan = _job_grants_fcfs(fl, jobs_ctx, cap_fl, t)
                bg.serve(bg_grants, k)
            elif jobs_ctx is not None:
                plan = _job_grants_bs(slots, fl, jobs_ctx, t, cyc, cap_cyc,
                                      N, cps_cap, n_pons)
            else:
                fl_grants = _slot_grants(slots, backlog_onu, t, cyc,
                                         cap_cyc, N)
                if cps_cap is not None:
                    want = fl_grants.sum(dim=1)
                    eff = cps_waterfill(want.reshape(-1, n_pons),
                                        cps_cap).reshape(-1)
                    if obs is not None:
                        ob_want, ob_eff = want, eff
                    if bool((eff < want).any()):
                        fl_grants = _slot_grants(slots, backlog_onu, t,
                                                 cyc, eff, N)
            if plan is not None:
                fl_grants = sum(g for _, g, _ in plan)
            if obs is not None:
                ob_fl_g = fl_grants
            if bool((fl_grants > 0.0).any()):
                prev_qb = fl.qb.clone()
                if plan is None:
                    fl.serve(fl_grants, backlog_onu)
                else:
                    # the jobs' columns are disjoint: a job with no grant
                    # drains nothing
                    for mask_j, g_j, bo_j in plan:
                        fl.serve(g_j, bo_j, mask_j)
                rem, done, done_t = _credit(
                    rem, done, done_t, prev_qb - fl.qb, t + cyc + prop)
                n_left = int((~done & part).count_nonzero())
        elif use_bg:
            if cps_cap is None:
                eff = cap_cyc
            else:
                want = torch.minimum(bg.backlog.sum(dim=1), cap_cyc)
                eff = cps_waterfill(want.reshape(-1, n_pons),
                                    cps_cap).reshape(-1)
                if obs is not None:
                    ob_want, ob_eff = want, eff
            bg_grants = _waterfill(bg.backlog, bg.hol_key, eff)
            if obs is not None:
                ob_bg, ob_bg_g = bg.backlog, bg_grants
            bg.serve(bg_grants, k)
        if obs is not None:
            # every cycle, idle ones included, as the reference records
            _observe_cycle(obs, cap_cyc, ob_want, ob_eff,
                           bg_backlog=ob_bg, fl_backlog=ob_fl,
                           bg_grants=ob_bg_g, fl_grants=ob_fl_g)
        t += cyc
        k += 1

    if cap_t is not None:
        # only deadline-free rows time out at max_t with filled times;
        # deadlined rows report their unserved rem instead
        left = part & ~done & ~dev(np.isfinite(deadline_row))[:, None]
        done_t = torch.where(left, t + prop, done_t)
    elif fill_unfinished:
        done_t = torch.where(part & ~done, t + prop, done_t)
    return done_t.cpu().numpy(), rem.cpu().numpy()


# ---------------------------------------------------------------------------
# sweep driver (host)
# ---------------------------------------------------------------------------


def _bs_slice(profiles: List[ClientProfile], capacity_bps: float):
    """Per-segment slice spec + slot arrays (a PON row of a multi-PON
    case may hold no clients)."""
    if not profiles:
        return None, slots_to_arrays([])
    spec = compute_slice(profiles, t_current=0.0, t_round=0.0,
                         capacity_bps=capacity_bps, h=1)
    return spec, slots_to_arrays(
        schedule_slots(profiles, spec, round_start=0.0))


def _stack_slots(per_row, n_onus: int):
    """Pad per-row slot arrays to a common (B, S) shape."""
    S = max(
        (len(a["client_id"]) for _, a in per_row), default=0
    ) or 1
    B = len(per_row)
    ts = np.full((B, S), np.inf)
    te = np.full((B, S), -np.inf)
    onu = np.zeros((B, S), np.int64)
    rate = np.zeros((B, 1))
    valid = np.zeros((B, S), bool)
    for b, (spec, a) in enumerate(per_row):
        s = len(a["client_id"])
        if s:
            ts[b, :s] = a["t_start"]
            te[b, :s] = a["t_end"]
            onu[b, :s] = a["client_id"] % n_onus
            valid[b, :s] = True
        if spec is not None:
            rate[b, 0] = spec.bandwidth_bps
    return ts, te, onu, rate, valid


def _stack_slots_jobs(per_row, n_onus: int):
    """Pad per-``(row, job)`` slot arrays to a common ``(B, S)`` shape.

    ``per_row[b]`` lists ``(job_index, spec, arrays)`` in job order.
    ``rate`` is per slot (each job carves its own slice) and ``sjob``
    binds every slot to its job (padding binds to job 0 with ``valid``
    False and wants nothing).
    """
    B = len(per_row)
    S = max(
        (sum(len(a["client_id"]) for _, _, a in row) for row in per_row),
        default=0,
    ) or 1
    ts = np.full((B, S), np.inf)
    te = np.full((B, S), -np.inf)
    onu = np.zeros((B, S), np.int64)
    rate = np.zeros((B, S))
    valid = np.zeros((B, S), bool)
    sjob = np.zeros((B, S), np.int64)
    for b, row in enumerate(per_row):
        s0 = 0
        for j, spec, a in row:
            s = len(a["client_id"])
            if not s:
                continue
            ts[b, s0:s0 + s] = a["t_start"]
            te[b, s0:s0 + s] = a["t_end"]
            onu[b, s0:s0 + s] = a["client_id"] % n_onus
            rate[b, s0:s0 + s] = spec.bandwidth_bps
            valid[b, s0:s0 + s] = True
            sjob[b, s0:s0 + s] = j
            s0 += s
    return ts, te, onu, rate, valid, sjob


def _sweep_topology(cases: Sequence[SweepCase]) -> MultiPonTopology:
    """The one topology shared by every case (None ≡ trivial)."""
    topos = {case.topology for case in cases}
    topos.discard(None)
    if len(topos) > 1:
        raise ValueError("sweep cases must share one MultiPonTopology")
    if not topos:
        return MultiPonTopology()
    topo = topos.pop()
    if any(case.topology is None for case in cases) and not topo.trivial:
        raise ValueError("sweep cases must share one MultiPonTopology")
    return topo


def _check_jobs_cases(cases: Sequence[SweepCase]):
    """Every case carries jobs partitioning its workload, or none do."""
    for b, case in enumerate(cases):
        if case.jobs is None:
            raise ValueError(
                f"cases[{b}] has no jobs but the sweep carries jobs; "
                "give every case a jobs tuple (or none)"
            )
        try:
            validate_case_jobs(case.jobs, case.workload)
        except ValueError as e:
            raise ValueError(f"cases[{b}]: {e}") from None


def _multi_job_fairness(cases: Sequence[SweepCase], ul_deadline_s,
                        ul_outage_s) -> str:
    """Validate a multi-tenant sweep; returns its fairness policy."""
    if ul_deadline_s is not None or ul_outage_s is not None:
        raise ValueError(
            "multi-job sweeps take per-job deadlines "
            "(JobSpec.deadline_s under fairness='deadline'), not "
            "round-level ul_deadline_s/ul_outage_s"
        )
    fair = {case.fairness for case in cases}
    if len(fair) != 1:
        raise ValueError(
            f"sweep cases must share one fairness policy; "
            f"got {sorted(fair)}"
        )
    fairness = fair.pop()
    if fairness not in FAIRNESS_POLICIES:
        raise ValueError(
            f"unknown fairness policy {fairness!r}; "
            f"have {FAIRNESS_POLICIES}"
        )
    for b, case in enumerate(cases):
        if case.dl_arrivals is not None or case.ul_arrivals is not None:
            raise ValueError(
                f"cases[{b}]: injected arrivals are a single-tenant "
                "parity hook; multi-job cases draw counter streams"
            )
        if case.no_dl_ids:
            raise ValueError(
                f"cases[{b}]: no_dl_ids (deadline carriers) do not "
                "compose with multi-job cases"
            )
    return fairness


def _record_job_uploads(collector, case: SweepCase, res):
    """Each job's upload times under ``<policy>/job<id>`` keys."""
    if collector is None or not res.job_stats:
        return
    ul = res.ul_done
    for job in case.jobs:
        times = [ul[cid] for cid in job.clients
                 if cid in ul and np.isfinite(ul[cid])]
        if times:
            collector.record_upload_times(
                f"{case.policy}/job{job.job_id}", case.load, times)


def _single_job_sweep(cfg, cases: Sequence[SweepCase], **kw):
    """A sweep whose every case has one job runs the single-tenant path
    (bit for bit a sweep of the same workloads without jobs) and gets
    its ``job_stats`` afterwards."""
    from repro_torch.net.sim import FLRoundWorkload

    norm = []
    for case in cases:
        job = case.jobs[0]
        wl = case.workload
        if float(job.model_bits) != float(wl.model_bits):
            wl = FLRoundWorkload(
                clients=wl.clients, model_bits=float(job.model_bits),
                t_aggregate=wl.t_aggregate,
            )
        norm.append(replace(case, jobs=None, workload=wl))
    results = _round_sweep(cfg, norm, **kw)
    topo = _sweep_topology(list(cases))
    for case, res in zip(cases, results):
        res.job_stats = compute_job_stats(
            case.jobs, res.ul_done, cfg.n_onus, topo.n_pons
        )
        _record_job_uploads(kw.get("collector"), case, res)
    return results


def _round_sweep(cfg, cases: Sequence[SweepCase],
                 t_round_hint: float = 10.0,
                 max_t: float = 600.0,
                 ul_deadline_s=None,
                 ul_outage_s=None,
                 collector=None,
                 backend: Optional[str] = None,
                 *, device=DEFAULT_DEVICE) -> List["RoundResult"]:  # noqa: F821
    """Simulate every sweep case as one stacked tensor simulation on
    ``device``.

    Semantics are those of ``repro.net.engine._round_sweep``: rows are
    ``(case, pon)`` pairs under the shared topology, ``ul_deadline_s``
    (scalar, or one entry per case with ``None``/``inf`` = none) cuts
    the upload phase and reports unserved bits in ``ul_remaining``,
    ``ul_outage_s`` (per case: ``None``, ``(2,)`` or ``(n_pons, 2)``
    ``[start, end)`` windows) darkens a row's capacity. ``backend``
    ``None``/``"numpy"`` runs the per-cycle loop, ``"jit"`` each phase
    in one call (injected arrival matrices are not taken there).
    Multi-tenant cases (``SweepCase.jobs``) split each cycle's FL
    capacity across jobs by their shared fairness policy; the phase
    kernel has no job axis, so with more than one job a case runs the
    per-cycle loop whatever ``backend`` says, as the JAX package does.
    ``collector`` records each phase's per-cycle metrics, the phases'
    spans and each case's upload times under ``(policy, load)`` (and
    each job's under ``<policy>/job<id>``); ``backend="jit"`` refuses it.
    """
    from repro_torch.net.sim import RoundResult

    device = resolve_device(device)
    cases = list(cases)
    if backend not in _BACKENDS:
        raise ValueError(f"unknown engine backend {backend!r}")
    use_jit = backend == "jit"
    if use_jit and collector is not None:
        raise ValueError("backend='jit' does not support collector "
                         "instrumentation; use the numpy backend")
    if use_jit and any(case.dl_arrivals is not None
                       or case.ul_arrivals is not None for case in cases):
        raise ValueError("backend='jit' does not support injected arrival "
                         "matrices; use the numpy backend")
    jobs_any = any(case.jobs is not None for case in cases)
    fairness = None
    if jobs_any:
        _check_jobs_cases(cases)
        if not any(len(case.jobs) > 1 for case in cases):
            return _single_job_sweep(
                cfg, cases, t_round_hint=t_round_hint, max_t=max_t,
                ul_deadline_s=ul_deadline_s, ul_outage_s=ul_outage_s,
                collector=collector, backend=backend, device=device,
            )
        fairness = _multi_job_fairness(cases, ul_deadline_s, ul_outage_s)
        # the phase kernel carries no job axis: the per-cycle loop runs
        use_jit = False
    topo = _sweep_topology(cases)
    P = topo.n_pons
    n_local = cfg.n_onus
    total_onus = P * n_local
    for b, case in enumerate(cases):
        if case.policy not in ("fcfs", "bs"):
            raise ValueError(f"unknown policy {case.policy!r}")
        if case.policy == "bs":
            bad = [c.client_id for c in case.workload.clients
                   if c.client_id >= total_onus]
            if bad:
                raise ValueError(
                    "bs policy requires client_id < n_onus * n_pons; "
                    f"got {bad}"
                )
        for name in ("dl_arrivals", "ul_arrivals"):
            arr = getattr(case, name)
            if arr is None:
                continue
            a = np.asarray(arr, np.float64)
            if a.ndim != 2 or a.shape[1] != total_onus:
                raise ValueError(
                    f"cases[{b}].{name} must be 2-D with "
                    f"n_pons * n_onus = {total_onus} columns; "
                    f"got shape {np.shape(arr)}"
                )
    lay = _Layout(cases, n_local, P)
    B = len(cases)
    R = B * P
    row_case = np.repeat(np.arange(B), P)
    row_pon = np.tile(np.arange(P), B)
    rates_pon = topo.rates(cfg)
    cap_row = np.tile(topo.capacity_bits(cfg), B)
    cps_cap = topo.cps_capacity_bits(cfg)
    per_onu_rate = np.stack([
        pon_bg_rates(c.workload.clients, c.workload.model_bits, c.load,
                     cfg, topo, t_round_hint,
                     model_bits_by_client=(
                         None if c.jobs is None else
                         {cid: float(job.model_bits)
                          for job in c.jobs for cid in job.clients}
                     ))
        for c in cases
    ])                                                  # (B, n_pons)
    per_case_dl = isinstance(ul_deadline_s, (list, tuple, np.ndarray))
    if per_case_dl:
        dl_case = np.array(
            [np.inf if d is None else float(d) for d in ul_deadline_s],
            np.float64,
        )
        if dl_case.shape != (B,):
            raise ValueError(
                f"per-case ul_deadline_s needs {B} entries; "
                f"got shape {dl_case.shape}"
            )
        dl_row = np.repeat(dl_case, P)
        ul_max_t = max_t
    else:
        dl_case = dl_row = None
        ul_max_t = max_t if ul_deadline_s is None else ul_deadline_s
    outage_row = None
    if ul_outage_s is not None:
        if len(ul_outage_s) != B:
            raise ValueError(
                f"per-case ul_outage_s needs {B} entries; "
                f"got {len(ul_outage_s)}"
            )
        outage_row = np.full((B, P, 2), np.inf)
        for b, win in enumerate(ul_outage_s):
            if win is None:
                continue
            arr = np.asarray(win, np.float64)
            if arr.shape == (2,):
                arr = np.broadcast_to(arr, (P, 2))
            if arr.shape != (P, 2):
                raise ValueError(
                    f"ul_outage_s[{b}] must be (2,) or ({P}, 2); "
                    f"got shape {arr.shape}"
                )
            outage_row[b] = arr
        outage_row = outage_row.reshape(R, 2)
        if not np.isfinite(outage_row[:, 0]).any():
            outage_row = None       # all-inf: the outage-free path
    no_dl = np.zeros((R, lay.n_clients), bool)
    for b, case in enumerate(cases):
        if case.no_dl_ids:
            skip = list(case.no_dl_ids)
            for p in range(P):
                no_dl[b * P + p] = np.isin(lay.cid_of[p], skip)
    no_dl &= lay.part

    # multi-tenant jobs: every live column binds to its job (jcol) and
    # carries its job's model bits (mb); every row knows its jobs'
    # weights and soft deadlines. Cases with fewer jobs pad to the max J
    # with phantom jobs that want nothing and get nothing.
    jobs_info = None
    if jobs_any:
        J = max(len(case.jobs) for case in cases)
        jcol = np.full((R, lay.n_clients), -1, np.int64)
        mb_col = np.zeros((R, lay.n_clients))
        w_row = np.ones((R, J))
        dl_jrow = np.full((R, J), np.inf)
        for b, case in enumerate(cases):
            jidx_of = {cid: j for j, job in enumerate(case.jobs)
                       for cid in job.clients}
            mb_of = {cid: float(job.model_bits) for job in case.jobs
                     for cid in job.clients}
            for p in range(P):
                r = b * P + p
                for col in np.nonzero(lay.part[r])[0]:
                    cid = int(lay.cid_of[p, col])
                    jcol[r, col] = jidx_of[cid]
                    mb_col[r, col] = mb_of[cid]
            for j, job in enumerate(case.jobs):
                w_row[b * P:(b + 1) * P, j] = float(job.weight)
                if job.deadline_s is not None:
                    dl_jrow[b * P:(b + 1) * P, j] = float(job.deadline_s)
        jobs_info = {"J": J, "jcol": jcol, "mb": mb_col, "w": w_row,
                     "dl": dl_jrow, "fairness": fairness}

    def jobs_ctx_for(sel):
        """The rows' per-job phase context (None when single-tenant)."""
        if jobs_info is None:
            return None
        jc = torch.as_tensor(jobs_info["jcol"][sel], device=device)
        return {
            "masks": [jc == j for j in range(jobs_info["J"])],
            "weights": torch.as_tensor(jobs_info["w"][sel], device=device),
            "deadlines": torch.as_tensor(jobs_info["dl"][sel],
                                         device=device),
            "fairness": jobs_info["fairness"],
        }

    def providers(sel, phase):
        entries = []
        for r in sel:
            b, p = int(row_case[r]), int(row_pon[r])
            case = cases[b]
            injected = (case.dl_arrivals if phase == "dl"
                        else case.ul_arrivals)
            if injected is not None:
                if P > 1:
                    arr = np.asarray(injected, np.float64)
                    injected = arr[:, p * n_local:(p + 1) * n_local]
                entries.append(_CaseFixed(injected, n_local, device))
            else:
                entries.append((
                    make_stream_key(case.seed, 0 if phase == "dl" else 1,
                                    case.stream_round, p),
                    burst_lambda(per_onu_rate[b, p], cfg.cycle_time_s,
                                 PACKET_BITS, cfg.bg_burst_packets),
                ))
        return _Stream(entries, n_local, 1.0 / cfg.bg_burst_packets,
                       device=device)

    def stream_params(sel, phase):
        """The raw ``(keys, lams)`` of ``providers(sel, phase)``: the jit
        phase samples the arrival stream itself."""
        ks = np.empty((len(sel), 2), np.uint32)
        ls = np.empty((len(sel),), np.float32)
        for i, r in enumerate(sel):
            b, p = int(row_case[r]), int(row_pon[r])
            ks[i] = make_stream_key(cases[b].seed, 0 if phase == "dl" else 1,
                                    cases[b].stream_round, p)
            ls[i] = burst_lambda(per_onu_rate[b, p], cfg.cycle_time_s,
                                 PACKET_BITS, cfg.bg_burst_packets)
        return ks, ls

    def run_phase(sub, rem0, ready, sel, phase, mode, **kw):
        global phase_fallbacks
        if use_jit:
            keys = lams = None
            if mode == "fcfs":
                keys, lams = stream_params(sel, phase)
            out = run_phase_device(
                cfg, sub, rem0, ready, mode, keys=keys, lams=lams,
                slot_arrays=kw.get("slot_arrays"), max_t=kw["max_t"],
                fill_unfinished=kw.get("fill_unfinished", True),
                cap_row=kw.get("cap_row"), cps_cap=kw.get("cps_cap"),
                n_pons=kw.get("n_pons", 1),
                deadline_row=kw.get("deadline_row"),
                outage_row=kw.get("outage_row"), device=device)
            if out is not None:
                return out
            # the ring walk lost exactness: the per-cycle loop is exact
            phase_fallbacks += 1
        stream = providers(sel, phase) if mode == "fcfs" else None
        label = f"{phase}:{mode}"
        with maybe_span(collector, f"phase:{label}", rows=len(sel)):
            return _run_phase(cfg, sub, rem0, ready, stream, mode,
                              collector=collector, phase_label=label,
                              device=device, **kw)

    # ---- downstream ------------------------------------------------------
    dl_done = np.full((R, lay.n_clients), np.nan)
    fcfs_rows = np.array(
        [r for r in range(R) if cases[row_case[r]].policy == "fcfs"],
        np.int64,
    )
    bs_rows = np.array(
        [r for r in range(R) if cases[row_case[r]].policy == "bs"],
        np.int64,
    )
    if len(fcfs_rows):
        sub = lay.rows(fcfs_rows)
        if jobs_info is None:
            bits = np.array([cases[row_case[r]].workload.model_bits
                             for r in fcfs_rows])[:, None]
        else:
            bits = jobs_info["mb"][fcfs_rows]
        rem0 = np.where(sub.part & ~no_dl[fcfs_rows], bits, 0.0)
        ready0 = np.zeros_like(rem0)
        dl_done[fcfs_rows], _ = run_phase(
            sub, rem0, ready0, fcfs_rows, "dl", "fcfs",
            max_t=max_t, cap_row=cap_row[fcfs_rows], cps_cap=cps_cap,
            n_pons=P, jobs_ctx=jobs_ctx_for(fcfs_rows),
        )
    for r in bs_rows:
        b, p = int(row_case[r]), int(row_pon[r])
        mb = (cases[b].workload.model_bits if jobs_info is None
              else jobs_info["mb"][r])
        t_bcast = mb / (rates_pon[p] * cfg.efficiency) + cfg.propagation_s
        dl_done[r] = np.where(lay.part[r], t_bcast, np.nan)
    dl_done = np.where(no_dl, 0.0, dl_done)

    ready_t = dl_done + lay.t_ud

    # ---- upstream --------------------------------------------------------
    ul_done = np.full((R, lay.n_clients), np.nan)
    ul_rem = np.zeros((R, lay.n_clients))
    specs: Dict[int, SliceSpec] = {}
    if len(fcfs_rows):
        sub = lay.rows(fcfs_rows)
        rem0 = np.where(sub.part, sub.m_ud, 0.0)
        ready = np.where(sub.part, ready_t[fcfs_rows], np.inf)
        ul_done[fcfs_rows], ul_rem[fcfs_rows] = run_phase(
            sub, rem0, ready, fcfs_rows, "ul", "fcfs",
            max_t=ul_max_t, fill_unfinished=ul_deadline_s is None,
            cap_row=cap_row[fcfs_rows], cps_cap=cps_cap, n_pons=P,
            deadline_row=None if dl_row is None else dl_row[fcfs_rows],
            outage_row=(None if outage_row is None
                        else outage_row[fcfs_rows]),
            jobs_ctx=jobs_ctx_for(fcfs_rows),
        )
    if len(bs_rows):
        per_row = []
        for r in bs_rows:
            b, p = int(row_case[r]), int(row_pon[r])
            dl_map = {
                int(lay.cid_of[p, j]): float(dl_done[r, j])
                for j in range(lay.n_clients) if lay.part[r, j]
            }

            def profiles(keep=None):
                return [
                    ClientProfile(
                        client_id=c.client_id,
                        t_ud=c.t_ud,
                        t_dl=dl_map[c.client_id],
                        m_ud_bits=c.m_ud_bits,
                        distance_m=c.distance_m,
                    )
                    for c in cases[b].workload.clients
                    if c.client_id in dl_map
                    and (keep is None or c.client_id in keep)
                ]

            capacity = float(rates_pon[p] * cfg.efficiency)
            if jobs_info is None:
                spec, arrays = _bs_slice(profiles(), capacity)
                if P == 1:
                    specs[b] = spec
                per_row.append((spec, arrays))
            else:
                # each job carves its own slice over its own clients;
                # the slots stay grouped job-major
                per_row.append([
                    (j, *_bs_slice(profiles(set(job.clients)), capacity))
                    for j, job in enumerate(cases[b].jobs)])
        sub = lay.rows(bs_rows)
        rem0 = np.where(sub.part, sub.m_ud, 0.0)
        ready = np.where(sub.part, ready_t[bs_rows], np.inf)
        ul_done[bs_rows], ul_rem[bs_rows] = run_phase(
            sub, rem0, ready, bs_rows, "ul", "bs",
            slot_arrays=(_stack_slots(per_row, n_local)
                         if jobs_info is None
                         else _stack_slots_jobs(per_row, n_local)),
            max_t=ul_max_t,
            fill_unfinished=ul_deadline_s is None,
            cap_row=cap_row[bs_rows], cps_cap=cps_cap, n_pons=P,
            deadline_row=None if dl_row is None else dl_row[bs_rows],
            outage_row=(None if outage_row is None
                        else outage_row[bs_rows]),
            jobs_ctx=jobs_ctx_for(bs_rows),
        )

    # ---- assemble --------------------------------------------------------
    results = []
    for b, case in enumerate(cases):
        dl: Dict[int, float] = {}
        rd: Dict[int, float] = {}
        ul: Dict[int, float] = {}
        remaining: Dict[int, float] = {}
        for p in range(P):
            r = b * P + p
            sel = lay.part[r]
            if not sel.any():
                continue
            ids = lay.cid_of[p][sel]
            dl.update(
                (int(i), float(v)) for i, v in zip(ids, dl_done[r, sel])
            )
            rd.update(
                (int(i), float(v)) for i, v in zip(ids, ready_t[r, sel])
            )
            ul.update(
                (int(i), float(v)) for i, v in zip(ids, ul_done[r, sel])
            )
            remaining.update(
                (int(i), float(v))
                for i, v in zip(ids, ul_rem[r, sel]) if v > 0.0
            )
        if per_case_dl:
            dlb = float(dl_case[b])
            has_dl = bool(np.isfinite(dl_case[b]))
        else:
            dlb = ul_deadline_s
            has_dl = ul_deadline_s is not None
        if remaining and has_dl:
            sync = dlb + case.workload.t_aggregate
        else:
            sync = max(ul.values()) + case.workload.t_aggregate
        if collector is not None:
            ul_times = [v for v in ul.values() if np.isfinite(v)]
            if ul_times:
                collector.record_upload_times(case.policy, case.load,
                                              ul_times)
        results.append(RoundResult(
            policy=case.policy,
            sync_time=sync,
            dl_done=dl,
            ready=rd,
            ul_done=ul,
            compute_bound=max(rd.values()),
            load=case.load,
            slice_spec=specs.get(b),
            ul_remaining=remaining if has_dl else None,
            job_stats=(None if case.jobs is None else
                       compute_job_stats(case.jobs, ul, n_local, P)),
        ))
        if case.jobs is not None:
            _record_job_uploads(collector, case, results[-1])
    return results


def simulate_round_sweep(cfg, cases=None,
                         t_round_hint: float = 10.0,
                         max_t: float = 600.0,
                         ul_deadline_s=None,
                         ul_outage_s=None,
                         collector=None,
                         backend: Optional[str] = None,
                         *, device=DEFAULT_DEVICE) -> List["RoundResult"]:  # noqa: F821
    """Public round-sweep entry point.

    Preferred form: ``simulate_round_sweep(spec)`` or
    ``simulate_round_sweep(cfg, spec)`` with a
    ``repro_torch.net.SweepSpec`` (the same call as ``simulate``). The
    keyword form ``simulate_round_sweep(cfg, cases, ...)`` still works
    and emits a ``DeprecationWarning``, as in the reference.
    """
    from repro_torch.net.api import SweepSpec, simulate

    spec = None
    pon = None
    if isinstance(cfg, SweepSpec):
        if cases is not None:
            raise TypeError(
                "simulate_round_sweep(spec) takes no second argument; "
                "put the PONConfig in spec.pon or call "
                "simulate_round_sweep(cfg, spec)"
            )
        spec = cfg
    elif isinstance(cases, SweepSpec):
        spec, pon = cases, cfg
    if spec is not None:
        if spec.schedule is not None:
            raise ValueError(
                "spec carries a schedule; call simulate(spec) or "
                "simulate_timeline_sweep(spec) for timelines"
            )
        return simulate(spec, pon, collector=collector, device=device)
    warnings.warn(
        "simulate_round_sweep(cfg, cases, **kwargs) is deprecated; "
        "build a repro_torch.net.SweepSpec and call simulate(spec)",
        DeprecationWarning, stacklevel=2,
    )
    return _round_sweep(
        cfg, cases, t_round_hint=t_round_hint, max_t=max_t,
        ul_deadline_s=ul_deadline_s, ul_outage_s=ul_outage_s,
        collector=collector, backend=backend, device=device,
    )
