"""Dispatch of the cycle engine's device work: the Hopper kernels for
CUDA tensors, their plain versions for CPU tensors.

* :func:`waterfill_grants` — one waterfill (K2), called per cycle by the
  engine's per-cycle loop;
* :func:`run_phase_device` — a whole transfer phase in one call, the
  port of the JAX package's ``backend="jit"`` phase program
  (``repro/kernels/ponsim/ops.py::run_phase_device``): one launch of the
  phase kernel (``kernel.run_phase_cuda``) on a card, ``ref.run_phase_ref``
  on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, FLOAT, resolve_device
from repro_torch.kernels.ponsim import kernel as _kernel
from repro_torch.kernels.ponsim import ref as _ref


def waterfill_grants(backlog, hol, cap, hard=None, *,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Oldest-first waterfill grants ``(R, N)`` float64 on ``device``.

    ``backlog`` ``(R, N)``, ``hol`` ``(R, N)`` head-of-line keys (float
    times or int64 cycles; lower is older), ``cap`` ``(R,)``; ``hard``
    optionally the precomputed ``ref.hard_rows``. Rows that are not
    hard get their backlog back unchanged.
    """
    dev = resolve_device(device)
    backlog = torch.as_tensor(backlog, dtype=FLOAT, device=dev)
    cap = torch.as_tensor(cap, dtype=FLOAT, device=dev)
    hol = torch.as_tensor(hol, device=dev)
    if hard is None:
        hard = _ref.hard_rows(backlog, cap)
    if dev.type == "cuda":
        # int64 cycle keys stay ordered (ties included) as float64 below
        # 2**53, and the empty-queue sentinel still sorts last
        return _kernel.waterfill_grants_cuda(
            backlog.contiguous(), hol.to(FLOAT).contiguous(),
            cap.contiguous(), hard.contiguous())
    return _ref.waterfill_grants_ref(backlog, hol, cap, hard)


def _fast_tables(cyc: float, k_max: int, lay, rem_init, ready_t) -> dict:
    """The scalar-S path's host tables (the JAX package's, in numpy):
    with one client an ONU, pushes are ready-driven and service follows
    a priority order known before the loop, so the FL queues collapse to
    one cumulative-service scalar a row against per-rank demand
    boundaries."""
    R, U = rem_init.shape
    ready = np.asarray(ready_t, np.float64)
    finite = np.isfinite(ready)
    # the loop's clock t (added cycle by cycle, as the kernel adds it) and
    # t + cyc, only as far as the latest finite ready time needs: a push
    # past it is no push (k_max), as over the whole clock
    last = float(ready[finite].max()) if finite.any() else 0.0
    n = min(k_max, int(last / cyc) + 16)
    while True:
        t_seq = np.empty(n, np.float64)
        t_seq[0] = 0.0
        if n > 1:
            np.cumsum(np.full(n - 1, cyc), out=t_seq[1:])
        tc = t_seq + cyc
        if n == k_max or tc[-1] >= last:
            break
        n = min(k_max, 2 * n)
    kp = np.where(finite, np.searchsorted(tc, ready.ravel()).reshape(R, U),
                  k_max)
    part_b = np.asarray(lay.part, bool)
    rem_b = np.asarray(rem_init, np.float64)
    pushes = part_b & (rem_b > 0.0) & (kp < k_max)
    pt = np.where(pushes,
                  np.maximum(ready, t_seq[np.minimum(kp, n - 1)]),
                  np.inf)
    # rank order: the waterfill's stable sort over per-ONU push times,
    # ties broken by ONU index
    onu_key = np.broadcast_to(np.asarray(lay.onu, np.int64), (R, U))
    rk = np.lexsort((onu_key, pt), axis=1)          # rank -> column
    rows = np.arange(R)[:, None]
    m_rank = np.where(pushes, rem_b, 0.0)[rows, rk]
    p_incl = np.zeros((R, U + 1))
    np.cumsum(m_rank, axis=1, out=p_incl[:, 1:])
    push_rank = pushes[rows, rk]
    q_bound = np.where(push_rank, p_incl[:, 1:], np.inf)
    rank_u = np.argsort(rk, axis=1)                 # column -> rank
    return {
        "kp_rank": np.where(push_rank, kp[rows, rk], k_max).astype(
            np.int32),
        "p_incl": p_incl,
        "q_bound": q_bound,
        "rank_u": rank_u.astype(np.int32),
        "rank_col": rk.astype(np.int32),
        "q_col": q_bound[rows, rank_u],
        "pushes": pushes,
        "m_live": (part_b & (rem_b > 0.0)).sum(axis=1).astype(np.int32),
    }


def _layout_tables(lay) -> dict:
    """Column ↔ ONU maps of the static slot layout: each ONU segment's
    first column, length and ONU; ``seg_idx`` pads each segment's
    columns to the longest with the dummy column ``U``."""
    U = len(lay.onu)
    seg_starts = np.asarray(lay.seg_starts, np.int64)
    seg_len = np.asarray(lay.seg_len, np.int64)
    j = np.arange(int(seg_len.max()), dtype=np.int64)
    seg_idx = np.where(j < seg_len[:, None], seg_starts[:, None] + j, U)
    return {
        "lay_onu": np.asarray(lay.onu, np.int64),
        "lay_pos": np.arange(U, dtype=np.int64),
        "seg_starts": seg_starts,
        "seg_len": seg_len,
        "seg_onus": np.asarray(lay.seg_onus, np.int64),
        "seg_idx": seg_idx,
    }


def _slot_tables(sonu, svalid, N: int) -> dict:
    """Each row's valid slots grouped by ONU: ``sorder`` the slots in
    order of ONU, slot order within an ONU (a stable sort; the invalid
    slots last, in no group), and ``ostart`` each ONU's first place in
    it (``N + 1`` offsets a row). Adding an ONU's slot grants in this
    order is the per-target order of the plain version's
    ``scatter_add_``; an invalid slot's grant is a zero, which changes
    no sum."""
    R, S = sonu.shape
    key = np.where(svalid, sonu, N)
    sorder = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    counts = np.bincount((np.arange(R)[:, None] * (N + 1) + key).ravel(),
                         minlength=R * (N + 1)).reshape(R, N + 1)
    ostart = np.zeros((R, N + 1), np.int32)
    np.cumsum(counts[:, :N], axis=1, out=ostart[:, 1:])
    return {"sorder": sorder, "ostart": ostart}


def pack(arrays: dict, device) -> dict:
    """The tensors of ``arrays`` (name -> numpy array) on ``device`` in
    one buffer: each array at a 16-byte boundary of one host buffer
    (pinned for a card), sent in one copy, and a view of it a name. On
    the CPU the views are of the host buffer itself."""
    dev = torch.device(device)
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    offs, total = {}, 0
    for name, arr in arrays.items():
        offs[name] = total
        total += -(-arr.nbytes // 16) * 16
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    flat = host.numpy()
    for name, arr in arrays.items():
        flat[offs[name]:offs[name] + arr.nbytes] = arr.reshape(-1).view(
            np.uint8)
    buf = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
    out = {}
    for name, arr in arrays.items():
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        view = buf[offs[name]:offs[name] + arr.nbytes].view(dtype)
        out[name] = view.view(arr.shape)
    return out


def phase_tables(cfg, lay, rem_init, ready_t, mode: str, *, keys=None,
                 lams=None, slot_arrays=None, max_t: float = 600.0,
                 fill_unfinished: bool = True, cap_row=None,
                 cps_cap: Optional[float] = None, n_pons: int = 1,
                 deadline_row=None, outage_row=None, use_k2: bool = False):
    """``(spec, arrays)`` of one phase: the ``ref.PhaseSpec`` and the
    phase's host tables (name -> numpy array), built as the JAX package
    builds them. The arguments are :func:`run_phase_device`'s."""
    from repro_torch.kernels.traffic.ops import _tail_bound
    from repro_torch.kernels.traffic.ref import WINDOW, poisson_thresholds
    from repro_torch.kernels.traffic.tables import burst_table
    from repro_torch.net.traffic import PACKET_BITS

    R, U = rem_init.shape
    N = int(cfg.n_onus)
    P = int(n_pons)
    if R % P:
        raise ValueError(f"{R} rows do not split into cases of {P} PONs")
    cyc = float(cfg.cycle_time_s)
    if cap_row is None:
        cap_row = np.full((R,), cfg.line_rate_bps * cyc * cfg.efficiency)
    has_deadline = deadline_row is not None
    if has_deadline:
        cap_t = np.where(np.isfinite(deadline_row), deadline_row, max_t)
        tmax = float(cap_t.max())
    else:
        tmax = float(max_t)
    k_max = int(np.ceil(max(tmax, 0.0) / cyc)) + 16
    lams = (np.zeros((R,), np.float32) if lams is None
            else np.asarray(lams, np.float32))
    has_bg = bool(mode == "fcfs" and lams.size and float(lams.max()) > 0.0)
    fast = mode == "fcfs" and bool(lay.single)
    dyn = {
        "part": np.asarray(lay.part, bool),
        "rem0": np.asarray(rem_init, np.float64),
        "ready": np.asarray(ready_t, np.float64),
        "list_pos": np.asarray(lay.list_pos, np.int64),
        "cap_col": np.asarray(cap_row, np.float64),
        **_layout_tables(lay),
    }
    if fast:
        dyn.update(_fast_tables(cyc, k_max, lay, rem_init, ready_t))
    if has_deadline:
        dyn["cap_t"] = np.asarray(cap_t, np.float64)
        dyn["finite_dl"] = np.isfinite(deadline_row)
    if outage_row is not None:
        dyn["out0"] = np.asarray(outage_row[:, 0], np.float64)
        dyn["out1"] = np.asarray(outage_row[:, 1], np.float64)
    n_draws = 0
    inv_burst = 1.0 / cfg.bg_burst_packets
    if has_bg:
        lam_w = np.asarray(lams, np.float64) * WINDOW
        n_draws = _tail_bound(float(lam_w.max()))
        dyn["keys"] = np.asarray(keys, np.uint32).astype(np.int64)
        dyn["thr"] = poisson_thresholds(lam_w, n_draws)
        starts, lengths = burst_table(inv_burst)
        dyn["bp_start"] = np.asarray(starts, np.int32)
        dyn["bp_len"] = np.asarray(lengths, np.int32)
    S = 1
    if mode == "bs":
        ts, te, sonu, srate, svalid = slot_arrays
        S = ts.shape[1]
        sonu = np.asarray(sonu, np.int64)
        svalid = np.asarray(svalid, bool)
        dyn.update(ts=np.asarray(ts, np.float64),
                   te_g=np.asarray(te, np.float64) + cyc, sonu=sonu,
                   srate=np.asarray(srate, np.float64), svalid=svalid,
                   **_slot_tables(sonu, svalid, N))
    spec = _ref.PhaseSpec(
        mode=mode, R=R, U=U, N=N, S=S, P=P, k_max=k_max, n_draws=n_draws,
        max_slots=int(np.asarray(lay.seg_len).max()), has_bg=has_bg,
        has_cps=cps_cap is not None, has_deadline=has_deadline,
        has_outage=outage_row is not None,
        fill_unfinished=bool(fill_unfinished), fast=fast,
        single=bool(lay.single), identity=bool(lay.identity),
        use_k2=bool(use_k2), cyc=cyc, prop=float(cfg.propagation_s),
        tmax=tmax, cps_cap=0.0 if cps_cap is None else float(cps_cap),
        packet_bits=float(PACKET_BITS), inv_burst=inv_burst)
    return spec, dyn


def phase_inputs(*args, use_k2: Optional[bool] = None,
                 device=DEFAULT_DEVICE, **kwargs):
    """``(spec, tensors)`` of one phase on ``device``: the
    ``ref.PhaseSpec`` and the phase's tensors, views of one buffer that
    crossed to the device in one copy (:func:`pack`). The arguments are
    :func:`run_phase_device`'s."""
    dev = resolve_device(device)
    if use_k2 is None:
        use_k2 = dev.type == "cuda"
    spec, arrays = phase_tables(*args, use_k2=use_k2, **kwargs)
    return spec, pack(arrays, dev)


def run_phase_device(cfg, lay, rem_init, ready_t, mode: str, *,
                     keys=None, lams=None, slot_arrays=None,
                     max_t: float = 600.0, fill_unfinished: bool = True,
                     cap_row=None, cps_cap: Optional[float] = None,
                     n_pons: int = 1, deadline_row=None, outage_row=None,
                     use_k2: Optional[bool] = None, device=DEFAULT_DEVICE,
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Run one transfer phase in one call on ``device``.

    The engine's ``_run_phase`` inputs, with the arrival stream given by
    its raw ``(keys, lams)`` (uint32 ``(R, 2)``, float32 ``(R,)``) so
    that the sampler runs inside the phase. Returns ``(done_t, rem)``
    numpy arrays, or ``None`` when the background's ring walk lost
    exactness (sustained overload aged a marginal queue's head out of
    the ``HISTORY_CYCLES`` ring, or the counting pour's clipped bucket
    was ambiguous); the caller then re-runs the phase on the per-cycle
    engine. ``use_k2`` pours the background's hard rows with K2's
    waterfill (the default on a card, the only pour the card has) or
    with the counting pour (the default on the CPU, as the JAX program
    pours on a CPU). The pours lose exactness on different phases (the
    counting pour also where its clipped age bucket is ambiguous), so
    the phases a sweep re-runs can differ between the CPU and the card;
    where both are exact they agree within rtol 1e-6.
    """
    spec, tens = phase_inputs(
        cfg, lay, rem_init, ready_t, mode, keys=keys, lams=lams,
        slot_arrays=slot_arrays, max_t=max_t,
        fill_unfinished=fill_unfinished, cap_row=cap_row, cps_cap=cps_cap,
        n_pons=n_pons, deadline_row=deadline_row, outage_row=outage_row,
        use_k2=use_k2, device=device)
    if tens["rem0"].is_cuda:
        # one launch, then one copy back (CPU tensors)
        done_t, rem, exact = _kernel.run_phase_cuda(spec, tens)
    else:
        done_t, rem, exact = _ref.run_phase_ref(spec, tens)
    if not exact:
        return None
    return done_t.numpy(), rem.numpy()
