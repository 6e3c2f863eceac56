"""Fault model and retry policy of the PON/FL co-simulation.

The port of ``repro.faults.model``. :class:`FaultSchedule` draws three
fault classes from the counter-based streams of
:mod:`repro_torch.faults.streams`:

* **client dropout** (``dropout_rate``): a pending client dies partway
  through its upload, after sending a fraction (a second uniform) of
  its pending bits; the round treats it as failed whatever the deadline
  policy.
* **ONU/link outage** (``outage_rate``): a PON's upstream goes dark for
  ``[start, start + duration)`` of the round's upload phase
  (phase-relative seconds). Outages mask capacity and cancel nothing,
  so outage-only schedules stay fold-legal.
* **payload loss** (``loss_rate``): a completed upload arrives corrupted
  and is discarded. The draw covers every pending client of the round,
  so it does not depend on what the simulation did.

Dropout and loss cancel an update; the client re-sends under
:class:`RetryPolicy` (exponential backoff in rounds, a bounded number of
attempts, then it gives up and re-enters fresh). A ``trivial`` schedule
(all rates zero) is bitwise ``faults=None``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np

from repro_torch.faults.streams import (
    FAULT_DROPOUT,
    FAULT_LOSS,
    FAULT_OUTAGE,
    fault_uniforms,
)

__all__ = ["FaultSchedule", "RetryPolicy"]


@dataclass(frozen=True)
class FaultSchedule:
    """Deterministic fault process shared by every case of a sweep.

    ``seed`` keys the fault streams; each case mixes in its own
    ``SweepCase.seed``, so cases draw independent faults while both
    engine backends, and any re-run of a round, agree exactly.
    """

    seed: int = 0
    dropout_rate: float = 0.0
    loss_rate: float = 0.0
    outage_rate: float = 0.0
    outage_duration_s: float = 0.5
    outage_start_max_s: float = 2.0

    def __post_init__(self):
        for name in ("dropout_rate", "loss_rate", "outage_rate"):
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]; got {v}")
            object.__setattr__(self, name, v)
        if self.outage_duration_s <= 0.0:
            raise ValueError("outage_duration_s must be positive")
        if self.outage_start_max_s < 0.0:
            raise ValueError("outage_start_max_s must be >= 0")

    @property
    def trivial(self) -> bool:
        """All rates zero: bitwise identical to ``None``."""
        return (self.dropout_rate == 0.0 and self.loss_rate == 0.0
                and self.outage_rate == 0.0)

    @property
    def couples_rounds(self) -> bool:
        """Dropout and loss book retries across rounds (no folding);
        outage-only schedules stay fold-legal."""
        return self.dropout_rate > 0.0 or self.loss_rate > 0.0

    def dropouts(self, round_index: int, client_ids: Sequence[int],
                 case_seed: int = 0) -> Dict[int, float]:
        """``{client_id: served fraction before death}`` of the round's
        dropout victims among ``client_ids``."""
        if self.dropout_rate == 0.0 or not len(client_ids):
            return {}
        ids = np.asarray(list(client_ids), np.int64)
        u_occ, u_frac = fault_uniforms(
            self.seed, FAULT_DROPOUT, round_index, ids, case_seed
        )
        hit = u_occ < self.dropout_rate
        return {int(i): float(f)
                for i, f in zip(ids[hit], u_frac[hit])}

    def losses(self, round_index: int, client_ids: Sequence[int],
               case_seed: int = 0) -> frozenset:
        """Clients whose completed upload would arrive corrupted."""
        if self.loss_rate == 0.0 or not len(client_ids):
            return frozenset()
        ids = np.asarray(list(client_ids), np.int64)
        u_occ, _ = fault_uniforms(
            self.seed, FAULT_LOSS, round_index, ids, case_seed
        )
        return frozenset(int(i) for i in ids[u_occ < self.loss_rate])

    def outage_windows(self, round_index: int, n_pons: int,
                       case_seed: int = 0) -> np.ndarray:
        """``(n_pons, 2)`` upstream outage ``[start, end)`` windows in
        phase-relative seconds; ``[inf, inf]`` rows mean no outage."""
        out = np.full((n_pons, 2), np.inf)
        if self.outage_rate == 0.0 or n_pons < 1:
            return out
        pons = np.arange(n_pons, dtype=np.int64)
        u_occ, u_start = fault_uniforms(
            self.seed, FAULT_OUTAGE, round_index, pons, case_seed
        )
        hit = u_occ < self.outage_rate
        start = u_start * self.outage_start_max_s
        out[hit, 0] = start[hit]
        out[hit, 1] = start[hit] + self.outage_duration_s
        return out


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential-backoff retransmission of a failed upload.

    A failure at round ``r`` on attempt ``a`` (1-based) schedules the
    re-send for round ``r + delay_rounds(a)``; past ``max_retries``
    attempts the client gives the update up and re-enters fresh.
    """

    base_delay_rounds: int = 1
    backoff: float = 2.0
    max_retries: int = 3

    def __post_init__(self):
        if self.base_delay_rounds < 1:
            raise ValueError("base_delay_rounds must be >= 1")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1.0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def delay_rounds(self, attempt: int) -> int:
        """Backoff in rounds before attempt ``attempt`` (1-based)."""
        return int(math.ceil(
            self.base_delay_rounds * self.backoff ** (attempt - 1)
        ))
