"""Hopper kernel K1: the counter-based Poisson-burst sampler.

Binds ``csrc/traffic.cu`` (the port of the TPU kernel
``repro/kernels/traffic/kernel.py::sample_arrival_bits_tpu``): one
launch a call and no other device operation. A CTA owns a tile of one
case, whole 64-cycle windows and an ONU span; it sums the tile's bursts
as integer packet counts in shared memory, its threads sharing the
bursts, and writes each output element once as float64 bits in the
kernel, from an output this wrapper allocates with ``torch.empty``. The
tiling is planned here on the host (:func:`_launch_plan`). The plain
version is ``ref.sample_arrival_bits_ref``; both give the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import _cuda
from repro_torch._device import FLOAT
from repro_torch.kernels.traffic.ref import WINDOW, _windows

THREADS = 128                # a CTA's threads: the most cells a tile holds
SMEM_LIMIT = 232_448         # dynamic shared memory a block may opt in to
_TARGET_TILES = 4 * 132      # four CTAs a streaming multiprocessor (the
                             # fastest target at both of the main path's
                             # shapes: scripts/profile_port_k1.py)
_MIN_SPAN = 16               # ONUs a tile at least, where a row has them
_GRID_LIMIT = 2**31 - 1      # CTAs a launch (grid x)
launches = 0                 # kernel launches since the last reset


@dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut into tiles, as ``csrc/traffic.cu`` reads it.

    Tile ``t`` (``0 <= t < n_tiles``, one CTA) is ONU span
    ``t % n_spans`` of window group ``t // n_spans % n_wtiles`` of case
    ``t // (n_spans * n_wtiles)``: ``span`` ONUs (fewer in the last
    span) of ``wpt`` whole windows (fewer in the last group), at most
    ``THREADS`` (window, ONU) cells. ``smem_bytes`` is its shared
    memory.
    """

    B: int
    n_cycles: int
    n_onus: int
    win0: int
    n_win: int
    lo: int
    span: int
    n_spans: int
    wpt: int
    n_wtiles: int
    n_tiles: int
    smem_bytes: int

    def region(self, t: int):
        """``(b, (cycle_lo, cycle_hi), (onu_lo, onu_hi))``: the output
        elements tile ``t`` writes, half-open, as the kernel computes
        them."""
        si, rest = t % self.n_spans, t // self.n_spans
        w_first = rest % self.n_wtiles * self.wpt
        b = rest // self.n_wtiles
        n_w = min(self.wpt, self.n_win - w_first)
        o0 = si * self.span
        width = min(self.span, self.n_onus - o0)
        r_base = w_first * WINDOW - self.lo
        r0 = max(0, -r_base)
        r1 = min(n_w * WINDOW, self.n_cycles - r_base)
        return b, (r_base + r0, r_base + r1), (o0, o0 + width)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _launch_plan(B: int, cycle0: int, n_cycles: int, n_onus: int,
                 n_draws: int, n_bp: int) -> LaunchPlan:
    """The tiles of a call (``B``, ``n_cycles``, ``n_onus`` >= 1).

    The span starts at a whole row (at most ``THREADS`` ONUs) and halves,
    down to ``_MIN_SPAN``, while the grid has fewer than
    ``_TARGET_TILES`` CTAs; a tile then takes as many windows as fill
    ``THREADS`` cells while the grid keeps that many. Raises
    ``ValueError`` past the card's shared memory or grid.
    """
    win0, n_win, lo = _windows(cycle0, n_cycles)

    def tiles(span: int, wpt: int) -> int:
        return B * _ceil_div(n_onus, span) * _ceil_div(n_win, wpt)

    span = min(n_onus, THREADS)
    while span > _MIN_SPAN and tiles(span, 1) < _TARGET_TILES:
        span = max(_MIN_SPAN, _ceil_div(span, 2))
    wpt = min(THREADS // span, n_win)
    while wpt > 1 and tiles(span, wpt) < _TARGET_TILES:
        wpt //= 2
    n_tiles = tiles(span, wpt)
    smem = 4 * (wpt * WINDOW * span + n_draws + 2 * n_bp + 2 * THREADS
                + THREADS // 32)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"n_draws={n_draws}: the kernel needs {smem} bytes of shared "
            f"memory a block, past the card's {SMEM_LIMIT}")
    if n_tiles > _GRID_LIMIT:
        raise ValueError(f"{n_tiles} tiles exceed the kernel's grid of "
                         f"{_GRID_LIMIT}")
    return LaunchPlan(B, n_cycles, n_onus, win0, n_win, lo, span,
                      _ceil_div(n_onus, span), wpt, _ceil_div(n_win, wpt),
                      n_tiles, smem)


def sample_arrival_bits_cuda(keys, cycle0: int, thresholds, starts,
                             lengths, packet_bits: float, *,
                             n_cycles: int, n_onus: int) -> torch.Tensor:
    """Arrival bits ``(B, n_cycles, n_onus)`` float64 on the card.

    ``keys`` int64 ``(B, 2)``; ``thresholds`` int32 ``(B, n_draws)``;
    ``starts``/``lengths`` int32 ``(T,)`` breakpoint table; all
    contiguous CUDA tensors on one device.
    """
    global launches
    B = keys.shape[0]
    _cuda.require(keys, "keys", torch.int64, (B, 2))
    _cuda.require(thresholds, "thresholds", torch.int32, (B, None))
    T = starts.shape[0]
    _cuda.require(starts, "starts", torch.int32, (T,))
    _cuda.require(lengths, "lengths", torch.int32, (T,))
    n_draws = thresholds.shape[1]
    if B < 1:
        raise ValueError(f"batch of {B} cases: the kernel needs at least 1")
    out = torch.empty((B, n_cycles, n_onus), dtype=FLOAT, device=keys.device)
    if not (n_cycles and n_onus):
        return out
    plan = _launch_plan(B, cycle0, n_cycles, n_onus, n_draws, T)
    lib = _cuda.library()
    with torch.cuda.device(keys.device):
        rc = lib.repro_traffic_sample(
            keys.data_ptr(), thresholds.data_ptr(), starts.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), float(packet_bits), n_draws,
            T, plan.win0 & 0xFFFFFFFF, plan.lo, plan.n_win, n_cycles, n_onus,
            plan.span, plan.n_spans, plan.wpt, plan.n_wtiles, plan.n_tiles,
            plan.smem_bytes, _cuda.stream_handle(keys))
    _cuda.check(rc, "traffic sampler")
    launches += 1
    return out
