"""Plain PyTorch versions of the cycle engine's grant primitives and of
the fused device phase.

* :func:`waterfill_grants_ref` — oldest-first sequential
  ``take = min(backlog, cap)`` grants as stable argsort + prefix-sum
  room, the plain version of the Hopper kernel K2 (``kernel.py``) and
  the mirror of the host engine's ``_waterfill``. Rows whose total
  demand sits at least one bit under capacity keep their backlog
  bitwise.
* :func:`cps_waterfill_ref` — the max-min CPS split across a case's
  PONs (or a row's jobs), at the closed-form water level.
* :func:`sample_window_ref` — one 64-cycle window of the Poisson-burst
  arrival stream, float32, the sampler the phase runs inside itself.
* :func:`run_phase_ref` — a whole transfer phase, one cycle per loop
  iteration: the plain version of the Hopper phase kernel
  (``kernel.run_phase_cuda``) and the port of the JAX package's device
  phase program (``repro/kernels/ponsim/ops.py::_build_program``).

On the CPU ``torch.cumsum`` adds left to right and the stable
``torch.argsort`` orders ties by index, so both equal the numpy engine
bit for bit; a CUDA ``cumsum`` is a parallel scan and may not.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch._device import FLOAT, np_sum, seq_cumsum
from repro_torch.kernels.traffic.ops import _table
from repro_torch.kernels.traffic.ref import WINDOW, packet_counts

CAP_EPS = 1e-9        # the DBAs' "capacity exhausted" threshold
SEG_EPS = 1.0         # segments under 1 bit are compacted
EPS_BITS = 1.0        # a client is done below 1 remaining bit
IKEY_INF = (2 ** 63 - 1) // 4     # empty-queue push key
HISTORY_CYCLES = 128  # the background prefix ring's length (power of 2)
SUM_LANES = 32        # row sums: 32 chunk partials, then their sum


def hard_rows(backlog: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Rows whose demand exceeds ``cap - 1``: only they need the sort."""
    return backlog.sum(dim=1) > cap - 1.0


def waterfill_grants_ref(backlog, hol, cap, hard=None) -> torch.Tensor:
    """Oldest-first waterfill grants ``(R, N)`` float64.

    ``hol`` sorts queues by head-of-line age (float times with ``inf``
    for empty queues, or integer arrival cycles); ``cap`` is the
    per-row capacity ``(R,)``; ``hard`` (optional) the precomputed
    :func:`hard_rows`.
    """
    if hard is None:
        hard = hard_rows(backlog, cap)
    order = torch.argsort(hol, dim=1, stable=True)
    b_s = torch.gather(backlog, 1, order)
    prefix = torch.cumsum(b_s, dim=1)
    room = cap[:, None] - (prefix - b_s)
    g_s = torch.where(room > CAP_EPS, torch.minimum(b_s, room), 0.0)
    g = torch.empty_like(backlog).scatter_(1, order, g_s)
    return torch.where(hard[:, None], g, backlog)


def cps_waterfill_ref(want: torch.Tensor, cap) -> torch.Tensor:
    """Max-min fair split of ``cap`` over each row of ``want`` ``(G, P)``.

    ``cap`` is a float or a per-row ``(G,)`` tensor. Rows within ``cap``
    (their total added in ``np.sum``'s order) return ``want`` unchanged;
    over rows sit at the water level ``eff_p = min(want_p, mu)``.
    """
    P = want.shape[1]
    cap = torch.as_tensor(cap, dtype=want.dtype, device=want.device
                          ).broadcast_to(want.shape[:1])
    over = np_sum(want) > cap + CAP_EPS
    cap = cap[:, None]
    ws = torch.sort(want, dim=1).values
    prev = seq_cumsum(ws) - ws
    # after granting the k smallest demands in full, the rest split the
    # residual evenly; the water level is the first feasible mu_k
    mu_k = (cap - prev) / (P - torch.arange(P, dtype=want.dtype,
                                            device=want.device))
    k = torch.argmax((mu_k <= ws).to(torch.int8), dim=1, keepdim=True)
    mu = torch.gather(mu_k, 1, k)
    return torch.where(over[:, None], torch.minimum(want, mu), want)


def sample_window_ref(keys, thresholds, win: int, *, n_onus: int,
                      n_draws: int, inv_burst: float, packet_bits: float
                      ) -> torch.Tensor:
    """Arrival bits ``(R, 64, n_onus)`` float32 of window ``win`` (cycles
    ``64·win … 64·win + 63``) of each row's stream.

    ``keys``: int64 ``(R, 2)`` uint32 stream keys; ``thresholds``: int32
    ``(R, n_draws)`` Poisson thresholds; burst lengths from the
    breakpoint table of ``inv_burst``. The same draws as
    ``traffic.ref.sample_arrival_bits_ref`` over those cycles, scaled
    ``float32(packets) · float32(packet_bits)`` as the JAX package's
    ``sample_window_ref`` does; packet counts are small integers, so the
    bits are exact.
    """
    if thresholds.shape[1] != n_draws:
        raise ValueError(f"thresholds have {thresholds.shape[1]} draws, "
                         f"not {n_draws}")
    starts, lengths = _table(float(inv_burst), keys.device)
    packets = packet_counts(keys, int(win) * WINDOW, thresholds, starts,
                            lengths, n_cycles=WINDOW, n_onus=n_onus)
    return packets.to(torch.float32) * torch.tensor(
        packet_bits, dtype=torch.float32)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums ``(R,)`` of ``x`` ``(R, n)`` in the phase kernel's fixed
    order: the row cut into ``SUM_LANES`` contiguous chunks of
    ``ceil(n / SUM_LANES)``, each added left to right, then the chunk
    partials left to right. CPU ``cumsum`` adds sequentially, so this
    equals the kernel bit for bit; a CUDA ``cumsum`` may not."""
    R, n = x.shape
    c = max(1, -(-n // SUM_LANES))
    xp = F.pad(x, (0, SUM_LANES * c - n))
    part = torch.cumsum(xp.view(R, SUM_LANES, c), dim=2)[:, :, -1]
    return torch.cumsum(part, dim=1)[:, -1]


def _cps_split(want: torch.Tensor, cap: float) -> torch.Tensor:
    """:func:`cps_waterfill_ref` over ``want`` ``(G, P)`` with the total
    added left to right, as the phase kernel adds it."""
    P = want.shape[1]
    over = torch.cumsum(want, dim=1)[:, -1] > cap + CAP_EPS
    ws = torch.sort(want, dim=1).values
    prev = torch.cumsum(ws, dim=1) - ws
    mu_k = (cap - prev) / (P - torch.arange(P, dtype=want.dtype,
                                            device=want.device))
    k = torch.argmax((mu_k <= ws).to(torch.int8), dim=1, keepdim=True)
    mu = torch.gather(mu_k, 1, k)
    return torch.where(over[:, None], torch.minimum(want, mu), want)


@dataclass(frozen=True)
class PhaseSpec:
    """What is static over one phase: shapes, which parts of the cycle
    body run, and the scalars. Built by ``ops.run_phase_device``.

    Rows are ``(case, pon)`` pairs, case-major, ``P`` to a case; ``U``
    client columns, ``N`` ONUs, ``S`` slots (``bs``). ``fast`` is the
    scalar-S path (``fcfs`` with one client an ONU), ``single`` /
    ``identity`` the layout's kind. ``use_k2`` pours the background's
    hard rows with the oldest-first waterfill over head-of-line cycles;
    otherwise with the counting pour over ``HISTORY_CYCLES`` age
    buckets.
    """

    mode: str
    R: int
    U: int
    N: int
    S: int
    P: int
    k_max: int
    n_draws: int
    max_slots: int
    has_bg: bool
    has_cps: bool
    has_deadline: bool
    has_outage: bool
    fill_unfinished: bool
    fast: bool
    single: bool
    identity: bool
    use_k2: bool
    cyc: float
    prop: float
    tmax: float
    cps_cap: float
    packet_bits: float
    inv_burst: float


def _per_onu(spec: PhaseSpec, dyn, x, fill):
    """Scatter single-layout columns ``(R, U)`` onto ONUs ``(R, N)``."""
    if spec.identity:
        return x
    out = torch.full((spec.R, spec.N), fill, dtype=x.dtype,
                     device=x.device)
    out[:, dyn["seg_onus"]] = x
    return out


def _segments(dyn, x: torch.Tensor, pad) -> torch.Tensor:
    """``(R, Sg, L)`` members of each ONU's column segment, padded."""
    col = torch.full((x.shape[0], 1), pad, dtype=x.dtype, device=x.device)
    return torch.cat([x, col], dim=1)[:, dyn["seg_idx"]]


def _heads(spec: PhaseSpec, dyn, qb, push_key):
    """Per ONU segment: whether it holds a queued client, and the column
    of its oldest pushed one (push key, then column)."""
    U = spec.U
    nonzero = qb > 0.0
    pk = torch.where(nonzero, push_key, 0)
    combined = torch.where(nonzero, pk * U + dyn["lay_pos"], IKEY_INF)
    m = _segments(dyn, combined, IKEY_INF).amin(dim=2)
    has = m < IKEY_INF
    return has, torch.where(has, m % U, 0)


def _hol_per_onu(spec: PhaseSpec, dyn, qb, push_key, push_time):
    """FCFS sort key of each ONU's FL queue: its head client's push time
    (``inf`` when empty)."""
    if spec.single:
        return _per_onu(spec, dyn, torch.where(qb > 0.0, push_time,
                                               torch.inf), torch.inf)
    has, pos = _heads(spec, dyn, qb, push_key)
    hol = torch.full((spec.R, spec.N), torch.inf, dtype=FLOAT,
                     device=qb.device)
    hol[:, dyn["seg_onus"]] = torch.where(
        has, torch.gather(push_time, 1, pos), torch.inf)
    return hol


def _slot_grants(spec: PhaseSpec, dyn, backlog_onu, t: float, cap):
    """Sliced-DBA grants ``(R, N)``: each active slot wants its overlap
    with the cycle times the slice rate, capped by its ONU's FL backlog;
    the wants are granted in slot order against ``cap``."""
    t_end = t + spec.cyc
    te_g = dyn["te_g"]
    active = dyn["svalid"] & (dyn["ts"] < t_end) & (te_g > t)
    overlap = (torch.clamp(te_g, max=t_end) - torch.clamp(dyn["ts"], min=t))
    want = dyn["srate"] * torch.clamp(overlap, min=0.0)
    want = torch.minimum(want, torch.gather(backlog_onu, 1, dyn["sonu"]))
    want = torch.where(active & (want > 0.0), want, 0.0)
    prefix = torch.cumsum(want, dim=1)
    grants = torch.minimum(
        want, torch.clamp(cap[:, None] - (prefix - want), min=0.0))
    return torch.zeros((spec.R, spec.N), dtype=FLOAT,
                       device=want.device).scatter_add_(1, dyn["sonu"],
                                                        grants)


def _counting_pour(b, ptr, e, k: int):
    """Background grants by age buckets (the JAX program's CPU pour):
    full backlogs for every bucket older than the marginal one, the
    marginal bucket poured in column order. Ages clip at
    ``HISTORY_CYCLES - 1``; a margin inside that clipped bucket with two
    or more queues may not follow arrival order, which the second
    result flags per row."""
    Wr = HISTORY_CYCLES
    has = b > 0.0
    age = torch.clamp(k - ptr, 0, Wr - 1)
    aidx = torch.where(has, age, 0)
    bval = torch.where(has, b, 0.0)
    bs = torch.zeros((b.shape[0], Wr), dtype=b.dtype,
                     device=b.device).scatter_add_(1, aidx, bval)
    csame = torch.cumsum(bs.flip(1), dim=1).flip(1)      # Σ age ≥ a
    colder = csame - bs                                  # Σ age > a
    tq = torch.gather(colder, 1, aidx)
    cq = torch.gather(csame, 1, aidx)
    capq = e[:, None]
    fullq = has & (cq <= capq)
    marg = has & (tq < capq) & (cq > capq)
    bm = torch.where(marg, bval, 0.0)
    wq = torch.cumsum(bm, dim=1) - bm
    room = capq - (tq + wq)
    pour = torch.where(room > CAP_EPS, torch.minimum(b, room), 0.0)
    g = torch.where(fullq, b, torch.where(marg, pour, 0.0))
    nclip = (has & (age == Wr - 1)).sum(dim=1)
    amb = (marg & (aidx == Wr - 1)).any(dim=1) & (nclip >= 2)
    return g, amb


def run_phase_ref(spec: PhaseSpec, dyn):
    """One transfer phase, one cycle per iteration.

    ``dyn`` holds the phase's tensors (``ops.phase_inputs`` builds them).
    On CPU tensors this equals the phase kernel bit for bit (the CPU's
    ``cumsum`` adds in order); it runs on CUDA tensors too, for timing. Returns ``(done_t, rem, exact)``: per-client completion times
    ``(R, U)`` (NaN outside a case), the bits still unserved, and
    whether the background ring walk stayed exact in every case while it
    ran. Each cycle runs the JAX program's body in its order: capacity
    masks, arrivals (a window sampled every 64 cycles) and the FIFO
    push, the FL push, the CPS split and grants, the background serve
    (full drains, then the one marginal queue a row, walked over the
    ``HISTORY_CYCLES``-cycle prefix ring) and the FL serve with its
    completion credit. Row sums are :func:`row_sum`'s.

    A case whose rows hold no live client stops counting towards
    ``exact``: the kernel stops its loop there, and its outputs are
    final (done is monotone and cases do not interact). The loop runs
    until no case is live, and unfinished clients are filled from that
    clock, as in the JAX program.
    """
    R, U, N, P = spec.R, spec.U, spec.N, spec.P
    cyc, prop = spec.cyc, spec.prop
    Wr = HISTORY_CYCLES
    part, rem0 = dyn["part"], dyn["rem0"]
    dev = rem0.device
    rows = torch.arange(R, device=dev)
    done0 = ~part | (rem0 <= 0.0)
    done_t = torch.full((R, U), torch.nan, dtype=FLOAT, device=dev)
    exact = True
    if spec.fast:
        fls = torch.zeros(R, dtype=FLOAT, device=dev)
        cdone = torch.zeros(R, dtype=torch.int64, device=dev)
        q_bound = dyn["q_bound"]
        qpad = torch.cat([q_bound, torch.full((R, 1), torch.inf,
                                              dtype=FLOAT, device=dev)], 1)
    else:
        rem = rem0.clone()
        done = done0.clone()
        waiting = part & ~done0
        qb = torch.zeros((R, U), dtype=FLOAT, device=dev)
        push_key = torch.full((R, U), IKEY_INF, dtype=torch.int64,
                              device=dev)
        push_time = torch.zeros((R, U), dtype=FLOAT, device=dev)
    if spec.has_bg:
        zeros = lambda: torch.zeros((R, N), dtype=FLOAT,  # noqa: E731
                                    device=dev)
        cum, drained, backlog = zeros(), zeros(), zeros()
        ptr = torch.zeros((R, N), dtype=torch.int64, device=dev)
        ring = torch.zeros((R, N, Wr), dtype=FLOAT, device=dev)
        ring_age = torch.arange(Wr, device=dev)
    k, t = 0, 0.0
    while True:
        if spec.fast:
            row_live = dyn["m_live"] > cdone
        else:
            row_live = (~done & part).any(dim=1)
        if spec.has_deadline:
            row_live = row_live & (dyn["cap_t"] > t)
        case_live = row_live.view(-1, P).any(dim=1)
        if not (t < spec.tmax and k < spec.k_max and bool(case_live.any())):
            break
        running = case_live.repeat_interleave(P)
        cap_cyc = dyn["cap_col"]
        if spec.has_deadline:
            cap_cyc = torch.where(dyn["cap_t"] > t, cap_cyc, 0.0)
        if spec.has_outage:
            dark = (dyn["out0"] <= t) & (t < dyn["out1"])
            cap_cyc = torch.where(dark, 0.0, cap_cyc)

        # ---- background arrivals (a window sampled every 64 cycles)
        if spec.has_bg:
            if k % WINDOW == 0:
                buf = sample_window_ref(
                    dyn["keys"], dyn["thr"], k // WINDOW, n_onus=N,
                    n_draws=spec.n_draws, inv_burst=spec.inv_burst,
                    packet_bits=spec.packet_bits)
            bits = buf[:, k % WINDOW, :].to(FLOAT)
            fresh = (backlog <= 0.0) & (bits > 0.0)
            cum = cum + bits
            backlog = cum - drained
            ptr = torch.where(fresh, k, ptr)
            ring[:, :, k & (Wr - 1)] = cum

        # ---- FL push
        if spec.fast:
            kk = torch.full((R, 1), k, dtype=torch.int32, device=dev)
            npk = torch.searchsorted(dyn["kp_rank"], kk, right=True)
            t_k = torch.gather(dyn["p_incl"], 1, npk)[:, 0]
            fl_tot = t_k - fls
        else:
            newly = waiting & (dyn["ready"] <= t + cyc)
            qb = torch.where(newly, rem, qb)
            push_key = torch.where(newly, k * (U + 1) + dyn["list_pos"],
                                   push_key)
            push_time = torch.where(
                newly, torch.clamp(dyn["ready"], min=t), push_time)
            waiting = waiting & ~newly
            if spec.single:
                backlog_onu = _per_onu(spec, dyn, qb, 0.0)
            else:
                # members added left to right, as the kernel adds them
                seg = _segments(dyn, qb, 0.0)
                acc = seg[:, :, 0]
                for j in range(1, seg.shape[2]):
                    acc = acc + seg[:, :, j]
                backlog_onu = torch.zeros((R, N), dtype=FLOAT, device=dev)
                backlog_onu[:, dyn["seg_onus"]] = acc

        # ---- grants
        if spec.mode == "fcfs":
            bg_sum = row_sum(backlog) if spec.has_bg else torch.zeros(
                R, dtype=FLOAT, device=dev)
            if not spec.fast:
                fl_want = row_sum(backlog_onu)
            if spec.has_cps:
                want = torch.minimum(
                    bg_sum + (fl_tot if spec.fast else fl_want), cap_cyc)
                eff = _cps_split(want.view(-1, P), spec.cps_cap).view(-1)
            else:
                eff = cap_cyc
            if spec.has_bg:
                easy = bg_sum <= eff - 1.0
                if bool(easy.all()):
                    # no row needs ordering: every queue is granted its
                    # backlog, as either pour grants it
                    bg_grants = backlog
                elif spec.use_k2:
                    hol = torch.where(backlog > 0.0, ptr.to(FLOAT),
                                      torch.inf)
                    bg_grants = waterfill_grants_ref(backlog, hol, eff,
                                                     ~easy)
                else:
                    g, amb = _counting_pour(backlog, ptr, eff, k)
                    bg_grants = torch.where(easy[:, None], backlog, g)
                    if bool((amb & ~easy & running).any()):
                        exact = False
                cap_fl = eff - row_sum(bg_grants)
            else:
                cap_fl = eff
            if not spec.fast:
                hard = fl_want > cap_fl - 1.0
                fl_grants = backlog_onu
                if bool(hard.any()):
                    fl_grants = waterfill_grants_ref(
                        backlog_onu, _hol_per_onu(spec, dyn, qb, push_key,
                                                  push_time), cap_fl, hard)
        else:
            fl_grants = _slot_grants(spec, dyn, backlog_onu, t, cap_cyc)
            if spec.has_cps:
                eff = _cps_split(row_sum(fl_grants).view(-1, P),
                                 spec.cps_cap).view(-1)
                fl_grants = _slot_grants(spec, dyn, backlog_onu, t, eff)

        # ---- background serve: full drains + the one marginal queue/row
        if spec.has_bg:
            full = (bg_grants > 0.0) & (bg_grants == backlog)
            budget = torch.where(full, 0.0, bg_grants)
            drained = torch.where(full, cum, drained)
            backlog = torch.where(full, 0.0, backlog)
            ptr = torch.where(full, k + 1, ptr)
            part_q = budget > CAP_EPS
            has_part = part_q.any(dim=1)
            if bool(has_part.any()):
                jm = torch.argmax(part_q.to(torch.int8), dim=1)
                tgt = drained[rows, jm] + budget[rows, jm]
                cum_q = cum[rows, jm]
                # the marginal queue's prefixes over the last Wr cycles,
                # oldest first (slots before cycle 0 hold 0)
                slot = (ring_age - (Wr - 1) + k) & (Wr - 1)
                pref = ring[rows, jm][:, slot]
                ex1 = pref > tgt[:, None]
                j1 = torch.argmax(ex1.to(torch.int8), dim=1)
                seg_end = torch.gather(pref, 1, j1[:, None])[:, 0]
                snap = seg_end - tgt <= SEG_EPS
                dr1 = torch.where(snap, seg_end, tgt)
                bklg = cum_q - dr1
                low = bklg < 0.5
                ex2 = (pref > dr1[:, None]) & (ring_age[None, :]
                                               > j1[:, None])
                j2 = torch.argmax(ex2.to(torch.int8), dim=1)
                new_pt = torch.where(
                    low, k + 1, k - (Wr - 1) + torch.where(snap, j2, j1))
                stale = has_part & ex1[:, 0] & (ptr[rows, jm]
                                                < k - (Wr - 1))
                if bool((stale & running).any()):
                    exact = False
                drained[rows, jm] = torch.where(
                    has_part, torch.where(low, cum_q, dr1),
                    drained[rows, jm])
                backlog[rows, jm] = torch.where(
                    has_part, torch.where(low, 0.0, bklg),
                    backlog[rows, jm])
                ptr[rows, jm] = torch.where(has_part, new_pt,
                                            ptr[rows, jm])

        # ---- FL serve + completion credit
        if spec.fast:
            capx = torch.clamp(cap_fl, min=0.0)
            s1 = torch.where(cap_fl > CAP_EPS,
                             torch.where(fl_tot <= capx, t_k, fls + capx),
                             fls)
            rkx = torch.searchsorted(q_bound, s1[:, None])
            qv = torch.gather(qpad, 1, rkx)[:, 0]
            bump = (s1 > fls) & (qv - s1 <= SEG_EPS)
            s2 = torch.where(bump, qv, s1)
            c_new = torch.searchsorted(q_bound, s2[:, None], right=True)
            rank_u = dyn["rank_u"]
            hit = (rank_u >= cdone[:, None]) & (rank_u < c_new)
            if bool(hit.any()):
                done_t = torch.where(hit, t + cyc + prop, done_t)
            fls, cdone = s2, c_new[:, 0]
        elif bool((fl_grants > 0.0).any()):
            # (with no grant no queue moves, so the serve is skipped)
            if spec.single:
                budget = (fl_grants if spec.identity
                          else fl_grants[:, dyn["lay_onu"]])
                act = (budget > CAP_EPS) & (qb > 0.0)
                take = torch.where(act, torch.minimum(budget, qb), 0.0)
                drop = act & (qb - take <= SEG_EPS)
                qb2 = torch.where(drop, 0.0, qb - take)
            else:
                fullf = (fl_grants > 0.0) & (fl_grants == backlog_onu)
                qb2 = torch.where(fullf[:, dyn["lay_onu"]], 0.0, qb)
                budget = torch.where(fullf, 0.0,
                                     fl_grants)[:, dyn["seg_onus"]]
                for _ in range(spec.max_slots):
                    has, pos = _heads(spec, dyn, qb2, push_key)
                    srv = has & (budget > CAP_EPS)
                    if not bool(srv.any()):
                        break       # no later pass would serve either
                    hq = torch.gather(qb2, 1, pos)
                    take = torch.where(srv, torch.minimum(budget, hq), 0.0)
                    resid = torch.where(srv, hq - take, torch.inf)
                    drop = srv & (resid <= SEG_EPS)
                    newq = torch.where(drop, 0.0, hq - take)
                    # unserved segments write a scratch column U
                    ext = torch.cat([qb2, torch.zeros((R, 1), dtype=FLOAT,
                                                      device=dev)], 1)
                    ext.scatter_(1, torch.where(srv, pos, U),
                                 torch.where(srv, newq, 0.0))
                    qb2 = ext[:, :U]
                    charge = torch.where(drop, resid, 0.0)
                    budget = torch.clamp(budget - take - charge, min=0.0)
            drained_fl = qb - qb2
            new_rem = rem - drained_fl
            newly_done = ~done & (drained_fl > 0.0) & (new_rem <= EPS_BITS)
            qb = qb2
            rem = torch.where(newly_done, 0.0, torch.clamp(new_rem, min=0.0))
            done = done | newly_done
            done_t = torch.where(newly_done, t + cyc + prop, done_t)
        k += 1
        t += cyc

    if spec.fast:
        scol = fls[:, None]
        pushes, q_col = dyn["pushes"], dyn["q_col"]
        done = done0 | (pushes & (q_col <= scol))
        rem = torch.where(pushes, torch.minimum(
            torch.clamp(q_col - scol, min=0.0), rem0), rem0)
    left = part & ~done
    if spec.has_deadline:
        left &= ~dyn["finite_dl"][:, None]
    if spec.has_deadline or spec.fill_unfinished:
        done_t = torch.where(left, t + prop, done_t)
    return done_t, rem, exact
