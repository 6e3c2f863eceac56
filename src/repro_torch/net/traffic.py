"""Background traffic parameters and counter-based arrival streams.

Arrivals are Poisson bursts of 1500-byte packets with a geometric
burst length (paper §3's Poisson background, made bursty).
"""
from __future__ import annotations

import torch

from repro_torch._device import DEFAULT_DEVICE

PACKET_BITS = 1500 * 8


def burst_lambda(rate_bps: float, cycle_s: float,
                 packet_bits: float = PACKET_BITS,
                 burst_packets: float = 16.0) -> float:
    """Per-cycle burst rate λ for an offered per-ONU bit rate."""
    if rate_bps <= 0:
        return 0.0
    return rate_bps / (packet_bits * burst_packets) * cycle_s


def background_rate_for_load(total_load: float, line_rate_bps: float,
                             training_rate_bps: float = 0.0) -> float:
    """Offered background rate so that background + training traffic
    make up ``total_load`` of the line rate."""
    rate = total_load * line_rate_bps - training_rate_bps
    return max(rate, 0.0)


class CounterStream:
    """Counter-based arrival rows of one (case, phase, round) stream.

    ``rows(k)`` is cycle ``k``'s ``(n_onus,)`` arrival bits on
    ``device``, materialised ``chunk`` cycles at a time; the values do
    not depend on the chunking.
    """

    def __init__(self, key, rate_bps: float, cycle_s: float, n_onus: int,
                 packet_bits: float = PACKET_BITS,
                 burst_packets: float = 16.0, chunk: int = 1024, *,
                 device=DEFAULT_DEVICE):
        self.key = key
        self.n_onus = n_onus
        self.packet_bits = packet_bits
        self.inv_burst = 1.0 / burst_packets
        self.lam = burst_lambda(rate_bps, cycle_s, packet_bits,
                                burst_packets)
        self.chunk = chunk
        self.device = device
        self._base = 0
        self._buf = None

    def rows(self, k: int) -> torch.Tensor:
        if self._buf is None or not (
            self._base <= k < self._base + len(self._buf)
        ):
            from repro_torch.kernels.traffic.ops import sample_arrival_bits

            self._base = k
            self._buf = sample_arrival_bits(
                self.key, k, self.chunk, self.n_onus, self.lam,
                self.inv_burst, self.packet_bits, device=self.device,
            )[0]
        return self._buf[k - self._base]
