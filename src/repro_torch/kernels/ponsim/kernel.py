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
  transfer phase in one launch, one block a case at any number of PONs,
  ONUs and clients an ONU (a case's state in shared memory where it
  fits, the rest in global scratch), with K1's window sampler and K2's
  waterfill inside it. It equals ``ref.run_phase_ref`` on the same
  inputs. ``phase_launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import _cuda
from repro_torch._device import FLOAT

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
         "k_max", "n_pad", "fast", "single", "fcfs", "has_bg", "has_cps",
         "has_deadline", "has_outage")
_FLOATS = ("cyc", "prop", "tmax", "cps_cap", "packet_bits")
_INPUTS = ("part", "rem0", "ready", "list_pos", "cap_col", "seg_starts",
           "seg_len", "seg_onus", "kp_rank", "p_incl", "q_bound", "rank_col",
           "q_col", "pushes", "m_live", "cap_t", "finite_dl", "out0", "out1",
           "keys", "thr", "bp_start", "bp_len", "ts", "te_g", "sorder",
           "ostart", "srate", "svalid")
# the outputs, one block of the launch's allocation (copied back at once):
# (name, dtype, per client or per case)
_OUTPUTS = (("done_t", FLOAT, "client"), ("rem", FLOAT, "client"),
            ("t_stop", FLOAT, "case"), ("k_stop", torch.int32, "case"),
            ("exact", torch.bool, "case"), ("left", torch.bool, "client"))


class _PhaseArgs(ctypes.Structure):
    """``PhaseArgs`` of ``csrc/ponsim_phase.cu``, field for field."""

    _fields_ = ([(n, _L) for n in _INTS] + [(n, _D) for n in _FLOATS]
                + [(n, _P) for n in _INPUTS]
                + [(n, _P) for n, _, _ in _OUTPUTS] + [("scratch", _P)])


def _padded(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _output_layout(R: int, U: int, B: int):
    """``[(name, dtype, shape, offset)]`` of the outputs in one byte
    buffer, each at a 16-byte boundary, and the buffer's size."""
    layout, off = [], 0
    for name, dtype, per in _OUTPUTS:
        shape = (R, U) if per == "client" else (B,)
        layout.append((name, dtype, shape, off))
        n = R * U if per == "client" else B
        off += -(-n * torch.empty((), dtype=dtype).element_size() // 16) * 16
    return layout, off


def _args(spec, dyn: dict) -> _PhaseArgs:
    n_bp = dyn["bp_start"].numel() if spec.has_bg else 0
    args = _PhaseArgs(
        R=spec.R, U=spec.U, N=spec.N, S=spec.S, P=spec.P,
        Sg=dyn["seg_starts"].numel(), max_slots=spec.max_slots,
        n_draws=spec.n_draws, n_bp=n_bp, k_max=spec.k_max,
        n_pad=_padded(spec.N), fast=spec.fast, single=spec.single,
        fcfs=spec.mode == "fcfs", has_bg=spec.has_bg, has_cps=spec.has_cps,
        has_deadline=spec.has_deadline, has_outage=spec.has_outage,
        cyc=spec.cyc, prop=spec.prop, tmax=spec.tmax, cps_cap=spec.cps_cap,
        packet_bits=spec.packet_bits)
    for name in _INPUTS:
        if name in dyn:
            setattr(args, name, dyn[name].data_ptr())
    return args


def _plan(lib, args: _PhaseArgs):
    """The library's plan for ``args`` on the current device (its words,
    handed back to the launch as they are)."""
    plan = (ctypes.c_longlong * lib.repro_phase_plan_words())()
    _cuda.check(lib.repro_phase_plan(ctypes.byref(args), plan), "phase plan")
    return plan


def phase_plan(spec, dyn: dict) -> dict:
    """Where a launch on ``spec`` keeps a case's state: the shared-memory
    bytes a CTA, the global scratch bytes a case, the regions in shared
    memory (by the library's names) and the threads a CTA, as the library
    plans them on the tensors' device."""
    lib = _cuda.library()
    with torch.cuda.device(dyn["rem0"].device):
        plan = _plan(lib, _args(spec, dyn))
    names = []
    while (name := lib.repro_phase_region_name(len(names))) is not None:
        names.append(name.decode())
    return {"smem_bytes": plan[0], "scratch_bytes": plan[1],
            "regions_on_chip": [name for i, name in enumerate(names)
                                if plan[2] >> i & 1],
            "threads": plan[3]}


def launch_phase(spec, dyn: dict) -> dict:
    """Launch the phase kernel once on ``spec`` and ``dyn`` (see
    :func:`run_phase_cuda`) without waiting for it; returns the output
    tensors (views of one block, ``"out"``), among them each case's stop
    cycle ``k_stop``. The outputs and the state the kernel keeps in
    global memory (what does not fit in shared memory) come from one
    allocation."""
    global phase_launches
    if not spec.use_k2:
        raise NotImplementedError(
            "the phase kernel pours hard background rows with K2's "
            "waterfill only; the counting pour on the card is ROADMAP "
            "Queue 2 (fused phase follow-ups)")
    dev = dyn["rem0"].device
    for name, t in dyn.items():
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    R, U, B = spec.R, spec.U, spec.R // spec.P
    lib = _cuda.library()
    if lib.repro_phase_args_bytes() != ctypes.sizeof(_PhaseArgs):
        raise RuntimeError("phase kernel arguments differ from the "
                           "library's layout")
    args = _args(spec, dyn)
    layout, out_bytes = _output_layout(R, U, B)
    with torch.cuda.device(dev):
        plan = _plan(lib, args)
        buf = torch.empty(out_bytes + B * plan[1], dtype=torch.uint8,
                          device=dev)
        state = {"out": buf[:out_bytes]}
        for name, dtype, shape, off in layout:
            n = shape[0] * (shape[1] if len(shape) > 1 else 1)
            size = n * torch.empty((), dtype=dtype).element_size()
            view = buf[off:off + size].view(dtype).view(shape)
            state[name] = view
            setattr(args, name, view.data_ptr())
        if plan[1]:
            args.scratch = buf.data_ptr() + out_bytes
        rc = lib.repro_ponsim_phase(ctypes.byref(args), B, plan,
                                    _cuda.stream_handle(dyn["rem0"]))
    _cuda.check(rc, "phase")
    phase_launches += 1
    return state


def run_phase_cuda(spec, dyn: dict):
    """One transfer phase in one launch: ``(done_t, rem, exact)`` as
    ``ref.run_phase_ref`` returns them, ``done_t``/``rem`` float64
    ``(R, U)`` CPU tensors, brought back in one device-to-host copy.

    ``spec`` is a ``ref.PhaseSpec`` (``use_k2`` must hold: the card pours
    hard background rows with K2's waterfill only); ``dyn`` the phase's
    contiguous CUDA tensors (``ops.phase_inputs`` builds them).
    """
    state = launch_phase(spec, dyn)
    host = state["out"].cpu().numpy()
    R, U, B = spec.R, spec.U, spec.R // spec.P
    layout, _ = _output_layout(R, U, B)
    out = {}
    for name, dtype, shape, off in layout:
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        n = shape[0] * (shape[1] if len(shape) > 1 else 1)
        out[name] = host[off:off + n * np_dtype.itemsize].view(
            np_dtype).reshape(shape)
    done_t = out["done_t"]
    if spec.has_deadline or spec.fill_unfinished:
        # the global loop's last cycle is the latest case's; its clock
        # fills the clients left unfinished
        t_end = out["t_stop"][np.argmax(out["k_stop"])]
        done_t = np.where(out["left"], t_end + spec.prop, done_t)
    return (torch.from_numpy(done_t), torch.from_numpy(out["rem"]),
            bool(out["exact"].all()))
