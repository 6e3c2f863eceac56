"""The paper's Bandwidth Slicing (BS) algorithm (Algorithm 1).

Host Python, the port's own copy of ``repro.core.slicing``: given the
involved clients' training times ``T_i^UD``, download times ``T_i^DL``
and update sizes ``M_i^UD``, compute the slice ``S{t_s, t_e, B}`` that
reserves uplink bandwidth so early clients upload inside the
stragglers' slack window::

    Δ_i    = T_i^UD + T_i^DL
    T^max  = max(Δ) + ∇          (∇ = serialization + propagation of the
    T^min  = min(Δ)               last arriving update)
    τ      = T^max − T^min
    B      = min(Σ_i M_i^UD / τ, C)
    t_s    = t_current + T^min + h·T^round
    t_e    = t_current + T^max + h·T^round

``B`` is sized by the deadline bound (:func:`deadline_bandwidth`), which
can only demand more than the paper's ``Σ M_i / τ``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

LIGHT_SPEED_FIBER = 2.0e8  # m/s


@dataclass(frozen=True)
class ClientProfile:
    """One involved client (ONU/EC node) of the FL task."""

    client_id: int
    t_ud: float            # local training time, seconds
    t_dl: float            # global model download time, seconds
    m_ud_bits: float       # model update size, bits
    distance_m: float = 20_000.0

    @property
    def delta(self) -> float:
        return self.t_ud + self.t_dl

    @property
    def propagation_s(self) -> float:
        return self.distance_m / LIGHT_SPEED_FIBER


@dataclass(frozen=True)
class SliceSpec:
    """Output of the BS algorithm: S{t_s, t_e, B} plus bookkeeping."""

    t_start: float
    t_end: float
    bandwidth_bps: float
    t_max: float
    t_min: float
    tau: float
    feasible: bool
    demanded_bps: float
    round_index: int = 1

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


def nabla(clients: Sequence[ClientProfile], capacity_bps: float) -> float:
    """∇: the straggler's update at line rate plus its propagation."""
    if not clients:
        return 0.0
    straggler = max(clients, key=lambda c: c.delta)
    return straggler.m_ud_bits / capacity_bps + straggler.propagation_s


def deadline_bandwidth(clients: Sequence[ClientProfile],
                       t_max: float) -> float:
    """Smallest B such that earliest-ready-first slots all end by
    ``t_max``: ``max_k Σ_{Δ_i >= Δ_(k)} M_i / (t_max − Δ_(k))``."""
    order = sorted(clients, key=lambda c: c.delta)
    suffix = 0.0
    best = 0.0
    for c in reversed(order):
        suffix += c.m_ud_bits
        remaining = t_max - c.delta
        if remaining <= 0:
            return float("inf")
        best = max(best, suffix / remaining)
    return best


def compute_slice(
    clients: Sequence[ClientProfile],
    t_current: float,
    t_round: float,
    capacity_bps: float,
    h: int = 1,
    sizing: str = "deadline",
) -> SliceSpec:
    """Algorithm 1 (BS); ``h`` is the number of rounds until the slice
    is first used."""
    if not clients:
        raise ValueError("BS algorithm needs a non-empty client set Φ")
    if h < 1:
        raise ValueError(f"h must be >= 1 (got {h})")

    deltas = sorted((c.delta for c in clients), reverse=True)
    grad = nabla(clients, capacity_bps)
    t_max = deltas[0] + grad
    t_min = deltas[-1]
    tau = max(t_max - t_min, 1e-9)

    total_bits = sum(c.m_ud_bits for c in clients)
    demanded = total_bits / tau
    if sizing == "deadline":
        demanded = max(demanded, deadline_bandwidth(clients, t_max))
    feasible = demanded <= capacity_bps
    bandwidth = min(demanded, capacity_bps)

    # infeasible at C: widen the window so every upload still fits at
    # line rate
    if not feasible:
        if sizing == "deadline":
            order = sorted(clients, key=lambda c: c.delta)
            suffix = 0.0
            t_needed = t_min
            for c in reversed(order):
                suffix += c.m_ud_bits
                t_needed = max(t_needed, c.delta + suffix / capacity_bps)
            t_max = t_needed
            tau = max(t_max - t_min, 1e-9)
        else:
            tau = total_bits / capacity_bps
            t_max = t_min + tau

    t_s = t_current + t_min + h * t_round
    t_e = t_current + t_max + h * t_round
    return SliceSpec(
        t_start=t_s,
        t_end=t_e,
        bandwidth_bps=bandwidth,
        t_max=t_max,
        t_min=t_min,
        tau=tau,
        feasible=feasible,
        demanded_bps=demanded,
        round_index=h,
    )


def validate_round_deadline(
    clients: Sequence[ClientProfile],
    spec: SliceSpec,
    t_round: float,
    t_aggregate: float = 0.0,
) -> bool:
    """Whether ``t_round`` covers every client's download, training,
    upload and the aggregation: each upload ends inside the slice, by
    ``t_max``, so the test is ``t_max + T_a <= t_round``."""
    return spec.t_max + t_aggregate <= t_round


def min_round_time(
    clients: Sequence[ClientProfile],
    capacity_bps: float,
    t_aggregate: float = 0.0,
) -> float:
    """The smallest feasible ``T^round`` for this client set."""
    spec = compute_slice(clients, 0.0, 0.0, capacity_bps, h=1)
    return spec.t_max + t_aggregate
