"""Federated partitioning: writers -> EC nodes/clients with heterogeneity."""
from __future__ import annotations

from typing import Callable, List

import numpy as np

from repro_torch.data.synthetic import femnist_like
from repro_torch.fl.client import Client, LocalTrainConfig


def build_federated_cnn_clients(
    n_clients: int,
    samples_per_client: int,
    loss_fn: Callable,
    train_cfg: LocalTrainConfig,
    seed: int = 0,
    t_ud_range=(1.0, 5.0),
) -> tuple:
    """LEAF-style clients with paper-faithful compute heterogeneity.

    T_i^UD ~ Uniform[1, 5] s (paper Fig 2b) — fixed per client across rounds
    (it is a property of the EC node's hardware + data volume).
    Returns (clients, test_set).
    """
    writers, test = femnist_like(n_clients, samples_per_client, seed=seed)
    rng = np.random.default_rng(seed + 1)
    t_uds = rng.uniform(*t_ud_range, size=n_clients)
    clients = [
        Client(
            client_id=i,
            data=writers[i],
            loss_fn=loss_fn,
            cfg=train_cfg,
            t_ud_s=float(t_uds[i]),
        )
        for i in range(n_clients)
    ]
    return clients, test


def partition_tokens(
    tokens: np.ndarray, n_clients: int, seq_len: int
) -> List[np.ndarray]:
    """Contiguous shards of a token stream, one per client (non-IID order)."""
    usable = (len(tokens) // (n_clients * (seq_len + 1))) * (seq_len + 1)
    shards = []
    for i in range(n_clients):
        start = i * usable
        shard = tokens[start : start + usable]
        shards.append(shard.reshape(-1, seq_len + 1))
    return shards
