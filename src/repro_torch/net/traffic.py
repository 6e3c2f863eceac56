"""Background traffic: Poisson-burst sources and counter-based streams.

Arrivals are Poisson bursts of 1500-byte packets with a geometric
burst length (paper §3's Poisson background, made bursty).
:class:`PoissonSource` and :class:`PrecomputedSource` feed the
cycle-level simulator (``net.sim``); :class:`CounterStream` holds the
keyed arrival rows the round engine draws, and its
:class:`CounterSource` views replay them one ONU at a time to the
cycle-level oracles.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE

PACKET_BITS = 1500 * 8


@dataclass
class PoissonSource:
    rate_bps: float                 # offered load in bits/s
    rng: np.random.Generator
    packet_bits: float = PACKET_BITS
    burst_packets: float = 16.0     # mean packets per burst (geometric)

    def arrivals(self, dt_s: float) -> float:
        """Bits arriving in a window of ``dt_s`` seconds: a Poisson count
        of bursts, then a geometric length per burst, drawn in that
        order from ``rng``."""
        if self.rate_bps <= 0:
            return 0.0
        mean_burst_bits = self.packet_bits * self.burst_packets
        burst_rate = self.rate_bps / mean_burst_bits     # bursts per second
        n_bursts = self.rng.poisson(burst_rate * dt_s)
        if n_bursts == 0:
            return 0.0
        lengths = self.rng.geometric(1.0 / self.burst_packets, size=n_bursts)
        return float(lengths.sum()) * self.packet_bits


@dataclass
class PrecomputedSource:
    """Replays a fixed per-cycle arrival sequence for one ONU; cycles
    past its end see no arrivals."""

    rows: "object"                  # 1-D sequence of bits per cycle
    cursor: int = 0

    def arrivals(self, dt_s: float) -> float:
        i = self.cursor
        self.cursor += 1
        if i >= len(self.rows):
            return 0.0
        return float(self.rows[i])


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
    not depend on the chunking. ``source(onu)`` is a per-ONU cursor for
    the cycle-level oracles; those read a float64 host copy of the
    chunk, made once a chunk (``host_copies`` counts them), not one
    device read an ONU a cycle.
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
        self.host_copies = 0
        self._base = 0
        self._buf = None
        self._host_base = 0
        self._host = None           # host copy of a chunk

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

    def host_row(self, k: int) -> np.ndarray:
        """``rows(k)`` as float64 numpy, from a host copy of its chunk."""
        if self._host is None or not (
            self._host_base <= k < self._host_base + len(self._host)
        ):
            self.rows(k)
            self._host = self._buf.cpu().numpy()
            self._host_base = self._base
            self.host_copies += 1
        return self._host[k - self._host_base]

    def source(self, onu: int) -> "CounterSource":
        return CounterSource(self, onu)


@dataclass
class CounterSource:
    """Per-ONU cursor view over a :class:`CounterStream`."""

    stream: CounterStream
    onu: int
    cursor: int = 0

    def arrivals(self, dt_s: float) -> float:
        k = self.cursor
        self.cursor += 1
        return float(self.stream.host_row(k)[self.onu])


def counter_streams_for_pons(seed: int, phase: int, per_onu_rates,
                             cycle_s: float, n_onus: int,
                             burst_packets: float = 16.0,
                             round_index: int = 0, *,
                             device=DEFAULT_DEVICE) -> list:
    """One :class:`CounterStream` per wavelength segment: segment ``p``
    draws from the stream keyed ``(seed, phase, round_index, pon=p)`` at
    its per-ONU rate ``per_onu_rates[p]``, the streams the stacked
    engine consumes."""
    from repro_torch.kernels.traffic.ops import make_stream_key

    return [
        CounterStream(
            make_stream_key(seed, phase, round_index, pon),
            float(rate), cycle_s, n_onus, burst_packets=burst_packets,
            device=device,
        )
        for pon, rate in enumerate(np.asarray(per_onu_rates, np.float64))
    ]


def per_onu_sources(total_rate_bps: float, n_onus: int,
                    rng: np.random.Generator,
                    burst_packets: float = 16.0) -> list:
    """Split an aggregate offered load evenly across ONUs."""
    rate = total_rate_bps / n_onus
    return [
        PoissonSource(rate_bps=rate, rng=rng, burst_packets=burst_packets)
        for _ in range(n_onus)
    ]
