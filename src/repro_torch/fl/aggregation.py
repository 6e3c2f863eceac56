"""Model aggregation strategies at the CPS.

``fedavg`` is the paper's choice (McMahan et al., AISTATS 2017): the global
model is the data-size-weighted average of client models. ``fedadam`` treats
the averaged client delta as a pseudo-gradient for a server Adam step
(Reddi et al., adaptive federated optimisation) — useful when client LRs are
small. ``FedBuffAggregator`` is the asynchronous buffer variant used by the
async mode of the co-simulation.

Parameter trees are nested dicts of tensors; averages accumulate in
float32 and cast back to each leaf's dtype, as the reference's do.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from repro_torch._device import full_float32
from repro_torch._tree import tree_leaves, tree_map


def fedavg(client_params: Sequence, weights: Sequence[float]):
    """Weighted average of client parameter trees (FedAvg)."""
    if len(client_params) == 0:
        raise ValueError("fedavg needs at least one client update")
    device = tree_leaves(client_params[0])[0].device
    w = torch.tensor(list(weights), dtype=torch.float32, device=device)
    w = w / torch.sum(w)

    def avg(*leaves):
        stacked = torch.stack([l.float() for l in leaves])
        out = torch.tensordot(w, stacked, dims=1)
        return out.to(leaves[0].dtype)

    with full_float32():
        return tree_map(avg, *client_params)


def fedavg_delta(global_params, client_params: Sequence,
                 weights: Sequence[float]):
    """Weighted-average *delta* (client - global); pseudo-gradient form."""
    avg = fedavg(client_params, weights)
    return tree_map(lambda a, g: a - g, avg, global_params)


@dataclass
class ServerAdamState:
    mu: object
    nu: object
    count: int = 0


def fedadam_init(global_params) -> ServerAdamState:
    def zeros():
        return tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32),
                        global_params)

    return ServerAdamState(mu=zeros(), nu=zeros())


def fedadam_step(
    global_params,
    state: ServerAdamState,
    client_params: Sequence,
    weights: Sequence[float],
    lr: float = 1e-2,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-3,
):
    """Server-side Adam on the averaged client delta."""
    delta = fedavg_delta(global_params, client_params, weights)
    count = state.count + 1
    mu = tree_map(lambda m, d: b1 * m + (1 - b1) * d.float(), state.mu,
                  delta)
    nu = tree_map(lambda v, d: b2 * v + (1 - b2) * torch.square(d.float()),
                  state.nu, delta)
    mu_hat = tree_map(lambda m: m / (1 - b1 ** count), mu)
    nu_hat = tree_map(lambda v: v / (1 - b2 ** count), nu)
    new_params = tree_map(
        lambda p, m, v: (
            p.float() + lr * m / (torch.sqrt(v) + eps)
        ).to(p.dtype),
        global_params,
        mu_hat,
        nu_hat,
    )
    return new_params, ServerAdamState(mu=mu, nu=nu, count=count)


def staleness_scale(staleness: float, power: float = 0.5) -> float:
    """``(1 + τ)^-p`` — the FedBuff staleness discount (p=0.5 default)."""
    return float((1.0 + float(staleness)) ** (-power))


def fedbuff_merge(global_params, deltas: Sequence,
                  weights: Sequence[float],
                  staleness: Optional[Sequence[float]] = None,
                  server_lr: float = 1.0,
                  staleness_power: float = 0.5,
                  fracs: Optional[Sequence[float]] = None):
    """Staleness-weighted buffered delta merge (FedBuff).

    ``G' = G + server_lr · Σ_i (w_i/Σ_j w_j) · s_i · f_i · Δ_i`` with
    ``s_i = (1+τ_i)^-p`` and ``f_i`` the served fraction (fp32
    accumulate, cast back). Data weights mix co-arrivals *relatively*
    (all fresh and complete ⇒ the FedAvg delta step); staleness and
    fraction discount *absolutely*, so a lone stale or partial arrival
    moves the global by ``s·f·Δ``, never the full delta. An empty buffer
    is a no-op.
    """
    deltas = list(deltas)
    if not deltas:
        return global_params
    taus = [0.0] * len(deltas) if staleness is None else list(staleness)
    fs = [1.0] * len(deltas) if fracs is None else list(fracs)
    total_w = float(sum(weights))
    if total_w <= 0.0:
        return global_params
    coeffs = [
        w / total_w * staleness_scale(t, staleness_power) * f
        for w, t, f in zip(weights, taus, fs)
    ]

    def step(p, *ds):
        upd = sum(c * d.float() for c, d in zip(coeffs, ds))
        return (p.float() + server_lr * upd).to(p.dtype)

    return tree_map(step, global_params, *deltas)


def quorum_threshold(n_expected: int, quorum_frac: float) -> int:
    """Minimum arrived-update count for a round to commit:
    ``max(1, ceil(quorum_frac * n_expected))``."""
    if n_expected < 0:
        raise ValueError("n_expected must be >= 0")
    if not 0.0 < quorum_frac <= 1.0:
        raise ValueError(f"quorum_frac must be in (0, 1]; got {quorum_frac}")
    return max(1, math.ceil(quorum_frac * n_expected))


def quorum_commit(global_params, deltas: Sequence,
                  weights: Sequence[float], *,
                  n_expected: int, quorum_frac: float,
                  staleness: Optional[Sequence[float]] = None,
                  fracs: Optional[Sequence[float]] = None,
                  server_lr: float = 1.0,
                  staleness_power: float = 0.5):
    """Quorum-gated merge: ``(new_global, quorum_met)``.

    With at least ``quorum_threshold(n_expected, quorum_frac)`` arrived
    updates the round commits through ``fedbuff_merge``; below the
    quorum the round *degrades* — the previous global model is returned
    unchanged (``quorum_met=False``) and the arrived updates are
    discarded.
    """
    deltas = list(deltas)
    if len(deltas) < quorum_threshold(n_expected, quorum_frac):
        return global_params, False
    return fedbuff_merge(
        global_params, deltas, weights, staleness=staleness,
        server_lr=server_lr, staleness_power=staleness_power,
        fracs=fracs,
    ), True


@dataclass
class FedBuffAggregator:
    """Asynchronous aggregation (FedBuff): apply once K updates buffered.

    Staleness is discounted with ``staleness_scale`` (1/sqrt(1+τ) at
    the default power) — a standard choice.
    """

    buffer_size: int = 8
    server_lr: float = 1.0
    staleness_power: float = 0.5
    _buffer: List = field(default_factory=list)

    def add(self, delta, weight: float, staleness: int = 0) -> bool:
        scale = weight * staleness_scale(staleness, self.staleness_power)
        self._buffer.append((delta, float(scale)))
        return len(self._buffer) >= self.buffer_size

    def flush(self, global_params):
        if not self._buffer:
            return global_params
        deltas = [d for d, _ in self._buffer]
        weights = [w for _, w in self._buffer]
        self._buffer.clear()
        return fedbuff_merge(
            global_params, deltas, weights, server_lr=self.server_lr
        )

    @property
    def pending(self) -> int:
        return len(self._buffer)
