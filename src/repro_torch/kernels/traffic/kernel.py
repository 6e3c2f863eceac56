"""Hopper kernel K1: the counter-based Poisson-burst sampler.

Binds ``csrc/traffic.cu`` (the port of the TPU kernel
``repro/kernels/traffic/kernel.py::sample_arrival_bits_tpu``): one
thread per (case, window, ONU) cell, bursts accumulated as integer
packet counts, scaled to float64 bits here. The plain version is
``ref.sample_arrival_bits_ref``; both give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda
from repro_torch._device import FLOAT
from repro_torch.kernels.traffic.ref import _windows

_SMEM_LIMIT = 48 * 1024           # default dynamic shared memory a block
launches = 0                      # kernel launches since the last reset


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
    if 4 * (n_draws + 2 * T) > _SMEM_LIMIT:
        raise ValueError(f"n_draws={n_draws} exceeds the kernel's shared "
                         "memory")
    if not 0 < B < 65536:
        raise ValueError(f"batch of {B} cases outside the kernel's grid")
    counts = torch.zeros((B, n_cycles, n_onus), dtype=torch.int32,
                         device=keys.device)
    if n_cycles and n_onus:
        win0, n_win, lo = _windows(cycle0, n_cycles)
        lib = _cuda.library()
        with torch.cuda.device(keys.device):
            rc = lib.repro_traffic_sample(
                keys.data_ptr(), thresholds.data_ptr(), starts.data_ptr(),
                lengths.data_ptr(), counts.data_ptr(), B, n_draws, T,
                win0 & 0xFFFFFFFF, lo, n_win, n_cycles, n_onus,
                _cuda.stream_handle(keys))
        _cuda.check(rc, "traffic sampler")
        launches += 1
    return counts.to(FLOAT) * float(packet_bits)
