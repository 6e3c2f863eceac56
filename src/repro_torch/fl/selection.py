"""Client selection strategies for each FL round.

* ``fraction`` — the paper's Fig 2a sweep: a fixed percentage of all clients
  participates each round (uniform without replacement).
* ``deadline`` — the Nishio-style baseline the paper argues against: drop
  stragglers that cannot meet the round deadline.
* ``all`` — full participation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.deadline import select_by_deadline
from repro_torch.core.slicing import ClientProfile


@dataclass(frozen=True)
class SelectionConfig:
    strategy: str = "fraction"     # "fraction" | "deadline" | "all"
    fraction: float = 1.0
    deadline_s: float = 6.0
    uplink_bps: float = 10e9


def select_clients(
    clients: Sequence[ClientProfile],
    cfg: SelectionConfig,
    rng: np.random.Generator,
) -> List[ClientProfile]:
    if cfg.strategy == "all":
        return list(clients)
    if cfg.strategy == "fraction":
        n = max(1, int(round(cfg.fraction * len(clients))))
        idx = rng.choice(len(clients), size=n, replace=False)
        return [clients[i] for i in sorted(idx)]
    if cfg.strategy == "deadline":
        selected, _ = select_by_deadline(
            clients, cfg.deadline_s, cfg.uplink_bps
        )
        return selected
    raise ValueError(f"unknown selection strategy {cfg.strategy!r}")
