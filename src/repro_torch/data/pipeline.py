"""Host-side batching of a token stream for LM training (numpy).

The counterpart of the reference package's ``data/pipeline.py``
``TokenBatcher``: the same blocks, the same ``np.random.default_rng``
permutations, so it yields the reference's batches in the reference's
order. Each pod sees a disjoint contiguous shard of the stream (the FL
property); the federated branch of ``launch/train.py`` stacks the pods'
batches to ``(n_pods, B / n_pods, S)`` on one device. The reference's
``shard_batch`` places a batch onto a device mesh; it waits for the
port's mesh and specs (``launch/mesh.py``, ``launch/specs.py``, ROADMAP
Queue 1 item 10).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenBatcher:
    def __init__(
        self,
        tokens: np.ndarray,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        pod_index: int = 0,
        n_pods: int = 1,
    ):
        shard_len = len(tokens) // max(n_pods, 1)
        tokens = tokens[pod_index * shard_len: (pod_index + 1) * shard_len]
        self.block = seq_len + 1
        n_seqs = len(tokens) // self.block
        self.data = tokens[: n_seqs * self.block].reshape(n_seqs, self.block)
        self.global_batch = global_batch
        self.rng = np.random.default_rng(seed)
        self.epoch = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            order = self.rng.permutation(len(self.data))
            for start in range(0, len(order) - self.global_batch + 1,
                               self.global_batch):
                rows = self.data[order[start: start + self.global_batch]]
                yield {
                    "tokens": rows[:, :-1].astype(np.int32),
                    "labels": rows[:, 1:].astype(np.int32),
                }
            self.epoch += 1
