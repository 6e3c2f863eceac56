"""Plain PyTorch version of the counter-based Poisson-burst sampler.

The sampler is a keyed pure function ``(key, onu, cycle) -> bits``
over fixed 64-cycle windows:

* draw 0 of a ``(window, onu)`` counter gives a 24-bit uniform, and the
  number of host-built Poisson(64λ) thresholds it exceeds is the
  window's burst count;
* draw ``j >= 1`` is burst ``j``: the top 6 bits of word 0 place it on
  a cycle of the window, word 1 (as a 24-bit uniform) gives its
  geometric packet count through the breakpoint table (``tables.py``).

The draw index is folded into the threefry key (Weyl increments), the
``(window, onu)`` pair is the counter, so any cycle range is
O(1)-seekable. Words are uint32 values carried in int64 and masked
(PyTorch has no uint32 arithmetic on the CPU). Packet counts are summed
as integers, so the order of the sum cannot change a bit; this is the
oracle the CUDA kernel (``kernel.py``) is held to, and it equals the
JAX package's numpy host path bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import FLOAT, MASK32

# Threefry-2x32 constants (Random123 / JAX's PRNG).
_C240 = 0x1BD11BDA
_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Weyl per-draw key derivation constants (golden ratio / murmur3).
KEY_WEYL_0 = 0x9E3779B9
KEY_WEYL_1 = 0x85EBCA6B
WINDOW = 64                       # cycles per sampling window
_WIN_SHIFT = 6


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """20-round Threefry-2x32 over broadcastable int64 tensors holding
    uint32 values; returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _C240)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for block in range(5):
        for r in _ROTS[block % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK32
    return x0, x1


def draw_key(k0, k1, d):
    """Key of draw ``d`` of a stream (Weyl-incremented key words)."""
    return (k0 + d * KEY_WEYL_0) & MASK32, k1 ^ ((d * KEY_WEYL_1) & MASK32)


def poisson_thresholds(lam_w, n_draws: int) -> np.ndarray:
    """int32 ``(B, n_draws)`` inverse-CDF thresholds of the window burst
    count: ``count = #{ j : bits24 > T_j }``,
    ``T_j = floor(CDF_Poisson(λ_w)(j) · 2²⁴)``.

    Host numpy float64 in log space, in the reference's operation order,
    so every backend counts bursts against the same integers.
    """
    lam_w = np.asarray(lam_w, np.float64).reshape(-1)
    j = np.arange(n_draws, dtype=np.float64)
    logfact = np.concatenate(
        [[0.0], np.cumsum(np.log(np.arange(1.0, n_draws)))]
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        lpmf = (-lam_w[:, None] + j[None, :] * np.log(lam_w)[:, None]
                - logfact[None, :])
    lpmf = np.where(lam_w[:, None] > 0.0, lpmf, -np.inf)
    lpmf[lam_w <= 0.0, 0] = 0.0    # λ=0: all mass at count 0
    cdf = np.cumsum(np.exp(lpmf), axis=1)
    return np.floor(
        np.minimum(cdf, 1.0) * float(1 << 24)
    ).astype(np.int32)


def _windows(cycle0: int, n_cycles: int):
    win0 = cycle0 >> _WIN_SHIFT
    n_win = ((cycle0 + n_cycles - 1) >> _WIN_SHIFT) - win0 + 1
    return win0, n_win, cycle0 - (win0 << _WIN_SHIFT)


def window_counts(keys, cycle0: int, n_cycles: int, n_onus: int,
                  thresholds) -> torch.Tensor:
    """Burst count per ``(case, window, onu)`` cell, int64
    ``(B, n_win, n_onus)``: draw 0 against the case's thresholds."""
    win0, n_win, _ = _windows(cycle0, n_cycles)
    dev = keys.device
    B = keys.shape[0]
    k0 = keys[:, 0].view(B, 1, 1)
    k1 = keys[:, 1].view(B, 1, 1)
    c0 = ((win0 + torch.arange(n_win, device=dev)) & MASK32).view(
        1, n_win, 1)
    c1 = torch.arange(n_onus, device=dev).view(1, 1, n_onus)
    w0, _ = threefry2x32(k0, k1, c0, c1)
    b24 = (w0 >> 8).expand(B, n_win, n_onus).reshape(B, -1)
    # thresholds are non-decreasing: #{T_j < b24} is a left search
    count = torch.searchsorted(thresholds.to(torch.int64).contiguous(),
                               b24.contiguous(), side="left")
    return count.view(B, n_win, n_onus)


def packet_counts(keys, cycle0: int, thresholds, starts, lengths, *,
                  n_cycles: int, n_onus: int) -> torch.Tensor:
    """Packets arriving per ``(case, cycle, onu)``, int64
    ``(B, n_cycles, n_onus)``: every live burst's breakpoint-table
    length added on the cycle its draw places it."""
    win0, n_win, lo = _windows(cycle0, n_cycles)
    dev = keys.device
    B = keys.shape[0]
    count = window_counts(keys, cycle0, n_cycles, n_onus, thresholds)
    packets = torch.zeros(B * n_cycles * n_onus, dtype=torch.int64,
                          device=dev)
    n_max = int(count.max()) if count.numel() else 0
    if n_max:
        # every draw up to the largest live count, dense over the cells;
        # draws beyond a cell's own count add nothing
        j = torch.arange(1, n_max + 1, device=dev).view(n_max, 1, 1, 1)
        kd0, kd1 = draw_key(keys[:, 0].view(1, B, 1, 1),
                            keys[:, 1].view(1, B, 1, 1), j)
        w = torch.arange(n_win, device=dev).view(1, 1, n_win, 1)
        onu = torch.arange(n_onus, device=dev).view(1, 1, 1, n_onus)
        x0, x1 = threefry2x32(kd0, kd1, (win0 + w) & MASK32, onu)
        place = x0 >> (32 - _WIN_SHIFT)
        run = torch.searchsorted(starts.to(torch.int64), x1 >> 8,
                                 right=True) - 1
        glen = lengths.to(torch.int64)[run]
        cyc = (w << _WIN_SHIFT) + place - lo
        ok = (j <= count.unsqueeze(0)) & (cyc >= 0) & (cyc < n_cycles)
        b = torch.arange(B, device=dev).view(1, B, 1, 1)
        dest = torch.where(ok, (b * n_cycles + cyc) * n_onus + onu, 0)
        packets.index_add_(0, dest.reshape(-1),
                           torch.where(ok, glen, 0).reshape(-1))
    return packets.view(B, n_cycles, n_onus)


def sample_arrival_bits_ref(keys, cycle0: int, thresholds, starts,
                            lengths, packet_bits: float, *,
                            n_cycles: int, n_onus: int) -> torch.Tensor:
    """Arrival bits ``(B, n_cycles, n_onus)`` float64.

    ``keys``: int64 ``(B, 2)`` uint32 stream keys; ``thresholds``: int32
    ``(B, n_draws)`` from :func:`poisson_thresholds`; ``starts`` /
    ``lengths``: the int32 breakpoint table of ``tables.burst_table``;
    all on one device.
    """
    packets = packet_counts(keys, cycle0, thresholds, starts, lengths,
                            n_cycles=n_cycles, n_onus=n_onus)
    return packets.to(FLOAT) * float(packet_bits)
