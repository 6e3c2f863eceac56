"""The CPS (centralized parameter server): round orchestration + aggregation.

Fault tolerance: clients can fail mid-round (``failure_prob``); the server
aggregates whatever arrived by the round deadline, weighted by data size —
the deadline-partial-aggregation strategy.

The global model is a dict of tensors; a round runs on its device. The
numpy ``rng`` is drawn in the reference's order — the selection, then for
each chosen client its failure roll and its local epochs' permutations —
so the port selects, drops and shuffles the same clients round by round.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch._tree import tree_map
from repro_torch.core.slicing import ClientProfile
from repro_torch.fl.aggregation import (
    fedavg,
    fedbuff_merge,
    quorum_threshold,
)
from repro_torch.fl.client import Client
from repro_torch.fl.compression import CompressorConfig, compress_delta
from repro_torch.fl.selection import SelectionConfig, select_clients


@dataclass
class RoundLog:
    round_index: int
    n_selected: int
    n_arrived: int
    mean_loss: float
    update_bits: float
    eval_metric: Optional[float] = None
    sync_time_s: Optional[float] = None
    # quorum aggregation: None = no quorum configured; False = the round
    # degraded to the previous global model (too few arrivals)
    quorum_met: Optional[bool] = None


@dataclass
class PendingUpdate:
    """A trained-and-compressed client update awaiting arrival at the
    CPS — the co-simulation holds these while the upload is in flight
    (deferred/async rounds) and applies them staleness-weighted when
    the network says they landed."""

    client_id: int
    delta: object                   # decoded wire delta vs base params (dict)
    weight: float                   # client data size
    loss: float                     # local training loss
    bits: float                     # wire bits of the full update


@dataclass
class CPSServer:
    global_params: object
    clients: List[Client]
    selection: SelectionConfig = field(default_factory=SelectionConfig)
    compression: CompressorConfig = field(
        default_factory=lambda: CompressorConfig(scheme="none")
    )
    failure_prob: float = 0.0
    seed: int = 0
    history: List[RoundLog] = field(default_factory=list)
    _error_states: Dict[int, object] = field(default_factory=dict)
    _round: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def profiles(self, model_bits: float) -> List[ClientProfile]:
        return [
            ClientProfile(
                client_id=c.client_id,
                t_ud=c.t_ud_s,
                t_dl=0.0,
                m_ud_bits=model_bits,
                distance_m=c.distance_m,
            )
            for c in self.clients
        ]

    def run_round(
        self,
        eval_fn: Optional[Callable] = None,
    ) -> RoundLog:
        """One synchronous round: select -> local train -> compress -> FedAvg."""
        self._round += 1
        selected = select_clients(
            [self._as_profile(c) for c in self.clients],
            self.selection,
            self.rng,
        )
        by_id = {c.client_id: c for c in self.clients}
        chosen = [by_id[p.client_id] for p in selected]

        arrived_params, weights, losses, bits_total = [], [], [], 0
        for client in chosen:
            if self.failure_prob and self.rng.random() < self.failure_prob:
                continue  # client failed / missed the deadline: skip its update
            local_params, loss = client.train(self.global_params, self.rng)
            delta = tree_map(
                lambda a, b: a - b, local_params, self.global_params
            )
            decoded, err, bits = compress_delta(
                delta, self.compression,
                self._error_states.get(client.client_id),
            )
            if err is not None:
                self._error_states[client.client_id] = err
            arrived = tree_map(
                lambda g, d: g + d, self.global_params, decoded
            )
            arrived_params.append(arrived)
            weights.append(client.n_samples)
            losses.append(loss)
            bits_total += bits

        if arrived_params:  # partial aggregation if some clients failed
            self.global_params = fedavg(arrived_params, weights)

        log = RoundLog(
            round_index=self._round,
            n_selected=len(chosen),
            n_arrived=len(arrived_params),
            mean_loss=float(np.mean(losses)) if losses else float("nan"),
            update_bits=float(bits_total),
            eval_metric=(
                float(eval_fn(self.global_params)) if eval_fn else None
            ),
        )
        self.history.append(log)
        return log

    def train_client_update(self, client: Client,
                            base_params) -> Optional[PendingUpdate]:
        """Local training + wire compression against ``base_params``.

        The returned ``PendingUpdate.delta`` is the *decoded* delta the
        CPS reconstructs (same error-feedback pipeline as the sync
        round); it stays pending until the network simulation delivers
        it — possibly rounds later, with staleness. ``failure_prob``
        rolls exactly as in :meth:`run_round`: a failed client returns
        ``None`` (its update is lost mid-round).
        """
        if self.failure_prob and self.rng.random() < self.failure_prob:
            return None
        local_params, loss = client.train(base_params, self.rng)
        delta = tree_map(lambda a, b: a - b, local_params, base_params)
        decoded, err, bits = compress_delta(
            delta, self.compression,
            self._error_states.get(client.client_id),
        )
        if err is not None:
            self._error_states[client.client_id] = err
        return PendingUpdate(
            client_id=client.client_id, delta=decoded,
            weight=float(client.n_samples), loss=float(loss),
            bits=float(bits),
        )

    def apply_updates(
        self,
        items: Sequence,
        eval_fn: Optional[Callable] = None,
        server_lr: float = 1.0,
        n_expected: Optional[int] = None,
        quorum_frac: Optional[float] = None,
    ) -> RoundLog:
        """One aggregation event: merge the arrived updates.

        ``items``: ``(update, staleness, frac)`` triples — a
        :class:`PendingUpdate`, its staleness in rounds, and the served
        fraction (1.0 for complete uploads; the network layer's
        ``deadline_policy="partial"`` delivers fractions). The global
        model moves by the staleness/fraction-discounted weighted delta
        (``fedbuff_merge`` — data weights mix relatively, the discounts
        apply absolutely); an empty event only advances the round
        counter (the deadline fired with nothing aggregated).

        ``quorum_frac`` (with ``n_expected`` pending uploads) gates the
        merge: fewer than ``quorum_threshold(n_expected, quorum_frac)``
        arrivals and the round degrades — the global model stands
        unchanged and the log records ``quorum_met=False``.
        """
        items = list(items)
        self._round += 1
        quorum_met: Optional[bool] = None
        if quorum_frac is not None:
            if n_expected is None:
                raise ValueError("quorum_frac needs n_expected")
            quorum_met = (
                len(items) >= quorum_threshold(n_expected, quorum_frac)
            )
        if items and quorum_met is not False:
            self.global_params = fedbuff_merge(
                self.global_params,
                [u.delta for u, _, _ in items],
                [u.weight for u, _, _ in items],
                [s for _, s, _ in items],
                server_lr=server_lr,
                fracs=[f for _, _, f in items],
            )
        losses = [u.loss for u, _, _ in items]
        log = RoundLog(
            round_index=self._round,
            n_selected=len(items),
            n_arrived=len(items),
            mean_loss=float(np.mean(losses)) if losses else float("nan"),
            update_bits=float(sum(u.bits * f for u, _, f in items)),
            eval_metric=(
                float(eval_fn(self.global_params)) if eval_fn else None
            ),
            quorum_met=quorum_met,
        )
        self.history.append(log)
        return log

    def _as_profile(self, c: Client) -> ClientProfile:
        return ClientProfile(
            client_id=c.client_id,
            t_ud=c.t_ud_s,
            t_dl=0.0,
            m_ud_bits=0.0,
            distance_m=c.distance_m,
        )
