"""Hopper kernels of the cycle engine, in float64.

* K2, the oldest-first waterfill grant: binds ``csrc/waterfill.cu`` (the
  port of the TPU kernel
  ``repro/kernels/ponsim/kernel.py::waterfill_grants_pallas``): one
  block per row, stable ranks by a bitonic sort of (key, index), a
  sequential prefix in rank order. It takes rows of any width: past the
  card's shared memory the wrapper hands the kernel a global scratch
  buffer. It equals ``ref.waterfill_grants_ref`` on the CPU bit for
  bit. ``launches`` counts its launches.
* The fused phase: binds ``csrc/ponsim_phase.cu`` (the port of the JAX
  package's device phase program, ``run_phase_device``): a whole
  transfer phase in one launch, one block a case, with K1's window
  sampler and K2's waterfill inside it. It equals ``ref.run_phase_ref``
  on the same inputs. ``phase_launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _cuda
from repro_torch._device import FLOAT
from repro_torch.kernels.ponsim.ref import HISTORY_CYCLES, WINDOW

launches = 0                      # K2 launches since the last reset
phase_launches = 0                # phase kernel launches since the last reset


def waterfill_grants_cuda(backlog: torch.Tensor, key: torch.Tensor,
                          cap: torch.Tensor, hard: torch.Tensor
                          ) -> torch.Tensor:
    """Grants ``(R, N)`` float64: the waterfill for ``hard`` rows, the
    backlog itself for the rest.

    ``backlog``/``key`` float64 ``(R, N)`` (keys must not be NaN),
    ``cap`` float64 ``(R,)``, ``hard`` bool ``(R,)``; contiguous CUDA
    tensors on one device.
    """
    global launches
    R, N = backlog.shape
    _cuda.require(backlog, "backlog", torch.float64, (R, N))
    _cuda.require(key, "key", torch.float64, (R, N))
    _cuda.require(cap, "cap", torch.float64, (R,))
    _cuda.require(hard, "hard", torch.bool, (R,))
    grants = torch.empty_like(backlog)
    if R and N:
        lib = _cuda.library()
        with torch.cuda.device(backlog.device):
            row_bytes = lib.repro_waterfill_scratch_bytes(N)
            if row_bytes < 0:
                raise RuntimeError("waterfill: cannot query the device's "
                                   "shared memory")
            scratch = (torch.empty(R * row_bytes, dtype=torch.uint8,
                                   device=backlog.device)
                       if row_bytes else None)
            rc = lib.repro_waterfill_grants(
                backlog.data_ptr(), key.data_ptr(), cap.data_ptr(),
                hard.data_ptr(), grants.data_ptr(), R, N,
                None if scratch is None else scratch.data_ptr(),
                _cuda.stream_handle(backlog))
        _cuda.check(rc, "waterfill")
        launches += 1
    return grants


_L, _D, _P = ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p
_INTS = ("R", "U", "N", "S", "P", "Sg", "max_slots", "n_draws", "n_bp",
         "k_max", "n_pad", "smem_pairs", "fast", "single", "identity",
         "fcfs", "has_bg", "has_cps", "has_deadline", "has_outage")
_FLOATS = ("cyc", "prop", "tmax", "cps_cap", "packet_bits")
_INPUTS = ("part", "rem0", "ready", "list_pos", "cap_col", "lay_onu",
           "onu_map", "seg_starts", "seg_len", "seg_onus", "kp_rank",
           "p_incl", "q_bound", "rank_u", "q_col", "pushes", "m_live",
           "cap_t", "out0", "out1", "keys", "thr", "bp_start", "bp_len",
           "ts", "te_g", "sonu", "srate", "svalid")
_STATE = ("cum", "drained", "backlog", "ptr", "ring", "win", "bg_grants",
          "qb", "push_key", "push_time", "waiting", "backlog_onu", "hol",
          "fl_grants", "slot_want", "done_t", "rem", "done", "k_stop",
          "t_stop", "exact")


class _PhaseArgs(ctypes.Structure):
    """``PhaseArgs`` of ``csrc/ponsim_phase.cu``, field for field."""

    _fields_ = ([(n, _L) for n in _INTS] + [(n, _D) for n in _FLOATS]
                + [(n, _P) for n in _INPUTS + _STATE])


def phase_limits() -> tuple:
    """The most PONs a case and clients an ONU the phase kernel takes,
    as the library defines them."""
    lib = _cuda.library()
    return int(lib.repro_phase_max_pons()), int(lib.repro_phase_max_clients())


def _padded(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def launch_phase(spec, dyn: dict) -> dict:
    """Launch the phase kernel once on ``spec`` and ``dyn`` (see
    :func:`run_phase_cuda`) without waiting for it; returns its state
    and output tensors, among them each case's stop cycle ``k_stop``."""
    global phase_launches
    if not spec.use_k2:
        raise NotImplementedError(
            "the phase kernel pours hard background rows with K2's "
            "waterfill only; the counting pour on the card is ROADMAP "
            "Queue 2 (fused phase follow-ups)")
    R, U, N, P, S = spec.R, spec.U, spec.N, spec.P, spec.S
    max_pons, max_clients = phase_limits()
    if P > max_pons or spec.max_slots > max_clients:
        raise NotImplementedError(
            f"the phase kernel takes up to {max_pons} PONs a case and "
            f"{max_clients} clients an ONU (got {P}, {spec.max_slots}): "
            "ROADMAP Queue 2 (fused phase follow-ups)")
    dev = dyn["rem0"].device
    for name, t in dyn.items():
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    B = R // P
    n_pad = _padded(N)
    sorts = spec.has_bg or (spec.mode == "fcfs" and not spec.fast)
    smem_pairs = n_pad * 12 if sorts else 0
    n_bp = dyn["bp_start"].numel() if spec.has_bg else 0
    smem = smem_pairs + 4 * (P * spec.n_draws + 2 * n_bp)
    lib = _cuda.library()
    if lib.repro_phase_args_bytes() != ctypes.sizeof(_PhaseArgs):
        raise RuntimeError("phase kernel arguments differ from the "
                           "library's layout")
    with torch.cuda.device(dev):
        limit = lib.repro_phase_smem_limit()
        if limit < 0:
            raise RuntimeError("phase kernel: cannot query the device's "
                               "shared memory")
        if smem > limit:
            raise NotImplementedError(
                f"rows of {N} ONUs need {smem} bytes of shared memory, "
                f"past the card's {limit}: ROADMAP Queue 2 (fused phase "
                "follow-ups)")

        def empty(shape, dtype, need=True):
            return torch.empty(shape if need else (0,), dtype=dtype,
                               device=dev)

        general = not spec.fast
        bg = spec.has_bg
        state = {
            "cum": empty((R, N), FLOAT, bg),
            "drained": empty((R, N), FLOAT, bg),
            "backlog": empty((R, N), FLOAT, bg),
            "ptr": empty((R, N), torch.int32, bg),
            "ring": empty((R, HISTORY_CYCLES, N), FLOAT, bg),
            "win": empty((R, WINDOW, N), torch.int32, bg),
            "bg_grants": empty((R, N), FLOAT, bg),
            "qb": empty((R, U), FLOAT, general),
            "push_key": empty((R, U), torch.int64, general),
            "push_time": empty((R, U), FLOAT, general),
            "waiting": empty((R, U), torch.bool, general),
            "backlog_onu": empty((R, N), FLOAT, general),
            "hol": empty((R, N), FLOAT, general and spec.mode == "fcfs"),
            "fl_grants": empty((R, N), FLOAT, general),
            "slot_want": empty((R, S), FLOAT, spec.mode == "bs"),
            "done_t": empty((R, U), FLOAT),
            "rem": empty((R, U), FLOAT),
            "done": empty((R, U), torch.bool),
            "k_stop": empty((B,), torch.int32),
            "t_stop": empty((B,), FLOAT),
            "exact": empty((B,), torch.bool),
        }
        args = _PhaseArgs(
            R=R, U=U, N=N, S=S, P=P, Sg=dyn["seg_starts"].numel(),
            max_slots=spec.max_slots, n_draws=spec.n_draws, n_bp=n_bp,
            k_max=spec.k_max, n_pad=n_pad, smem_pairs=smem_pairs,
            fast=spec.fast, single=spec.single, identity=spec.identity,
            fcfs=spec.mode == "fcfs", has_bg=bg, has_cps=spec.has_cps,
            has_deadline=spec.has_deadline, has_outage=spec.has_outage,
            cyc=spec.cyc, prop=spec.prop, tmax=spec.tmax,
            cps_cap=spec.cps_cap, packet_bits=spec.packet_bits)
        for name in _INPUTS:
            if name in dyn:
                setattr(args, name, dyn[name].data_ptr())
        for name, t in state.items():
            if t.numel():
                setattr(args, name, t.data_ptr())
        threads = min(512, max(128, n_pad // 2))
        rc = lib.repro_ponsim_phase(ctypes.byref(args), B, threads, smem,
                                    _cuda.stream_handle(dyn["rem0"]))
    _cuda.check(rc, "phase")
    phase_launches += 1
    return state


def run_phase_cuda(spec, dyn: dict):
    """One transfer phase in one launch: ``(done_t, rem, exact)`` as
    ``ref.run_phase_ref`` returns them, ``done_t``/``rem`` float64
    ``(R, U)`` CUDA tensors.

    ``spec`` is a ``ref.PhaseSpec`` (``use_k2`` must hold: the card pours
    hard background rows with K2's waterfill only); ``dyn`` the phase's
    contiguous CUDA tensors (``ops.phase_inputs`` builds them).
    """
    state = launch_phase(spec, dyn)
    # the global loop's last cycle is the latest case's; its clock fills
    # the clients left unfinished
    done_t, done = state["done_t"], state["done"]
    t_end = state["t_stop"][torch.argmax(state["k_stop"])]
    left = dyn["part"] & ~done
    if spec.has_deadline:
        left &= ~dyn["finite_dl"][:, None]
    if spec.has_deadline or spec.fill_unfinished:
        done_t = torch.where(left, t_end + spec.prop, done_t)
    return done_t, state["rem"], bool(state["exact"].all())
