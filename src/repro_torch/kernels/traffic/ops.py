"""Public counter-based traffic sampling ops.

``sample_arrival_bits`` materialises any ``(cycle0, n_cycles)`` window
of the per-ONU background arrival process for a batch of stream keys,
identically however the caller chunks the cycles. On a CUDA device it
launches the Hopper kernel (``kernel.py``); on the CPU it runs the plain
version (``ref.py``). Both reproduce the JAX package's stream bit for
bit.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, FLOAT, MASK32, resolve_device
from repro_torch.kernels.traffic import kernel as _kernel
from repro_torch.kernels.traffic import ref as _ref
from repro_torch.kernels.traffic.tables import burst_table

# Weyl constants mixing the PON index into a stream key (murmur3 c1/c2;
# distinct from ref.KEY_WEYL_* so a pon-shifted stream never aliases
# another stream's per-draw keys).
_PON_WEYL_0 = 0xCC9E2D51
_PON_WEYL_1 = 0x1B873593
# the same for a tenant-job index
_JOB_WEYL_0 = 0xC2B2AE35
_JOB_WEYL_1 = 0x27D4EB2F


def make_stream_key(seed: int, phase: int, round_index: int = 0,
                    pon: int = 0, job: int = 0) -> np.ndarray:
    """uint32 ``(2,)`` key of one case's (phase, round, pon, job) stream.

    ``seed`` fills one word, ``(phase, round)`` the other, and the PON
    and job indices Weyl-shift both; threefry does the mixing.
    """
    return np.array(
        [
            (seed + pon * _PON_WEYL_0 + job * _JOB_WEYL_0) & MASK32,
            (phase + 2 * round_index + pon * _PON_WEYL_1
             + job * _JOB_WEYL_1) & MASK32,
        ],
        np.uint32,
    )


def _tail_bound(lam_w: float) -> int:
    """Draw budget with negligible truncated Poisson tail for the
    per-window burst rate: ``λ_w + 12·sqrt(λ_w+1) + 8``, rounded up to a
    multiple of 8."""
    k = int(math.ceil(lam_w + 12.0 * math.sqrt(lam_w + 1.0) + 8.0))
    return max(8, int(math.ceil(k / 8.0)) * 8)


@functools.lru_cache(maxsize=8)
def _table(inv_burst: float, device: torch.device):
    starts, lengths = burst_table(inv_burst)
    return (torch.tensor(starts, dtype=torch.int32, device=device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def sample_arrival_bits(keys, cycle0: int, n_cycles: int, n_onus: int,
                        lam, inv_burst: float, packet_bits: float, *,
                        device=DEFAULT_DEVICE) -> torch.Tensor:
    """Arrival bits ``(B, n_cycles, n_onus)`` float64 on ``device``.

    ``keys``: uint32 ``(B, 2)`` (or ``(2,)``); ``lam``: per-case
    per-cycle burst rate, scalar or ``(B,)``, taken as float32 like the
    reference; ``inv_burst``: 1/mean burst packets (only 1/16 has a
    table).
    """
    dev = resolve_device(device)
    keys = np.atleast_2d(np.asarray(keys, np.uint32))
    B = keys.shape[0]
    lam_arr = np.ascontiguousarray(np.broadcast_to(
        np.asarray(lam, np.float32), (B,)))
    starts, lengths = _table(float(inv_burst), dev)
    lam_max = float(lam_arr.max())
    if lam_max <= 0.0:
        return torch.zeros((B, n_cycles, n_onus), dtype=FLOAT, device=dev)
    n_draws = _tail_bound(lam_max * _ref.WINDOW)
    thr = _ref.poisson_thresholds(
        np.asarray(lam_arr, np.float64) * _ref.WINDOW, n_draws)
    keys_t = torch.as_tensor(keys.astype(np.int64), device=dev)
    thr_t = torch.as_tensor(thr, device=dev)
    if dev.type == "cuda":
        return _kernel.sample_arrival_bits_cuda(
            keys_t, int(cycle0), thr_t, starts, lengths, packet_bits,
            n_cycles=n_cycles, n_onus=n_onus)
    return _ref.sample_arrival_bits_ref(
        keys_t, int(cycle0), thr_t, starts, lengths, packet_bits,
        n_cycles=n_cycles, n_onus=n_onus)
