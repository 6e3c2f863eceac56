"""Host-side batching of a token stream for LM training (numpy), and
its placement onto a device mesh.

The counterpart of the reference package's ``data/pipeline.py``:
``TokenBatcher`` makes the same blocks with the same
``np.random.default_rng`` permutations, so it yields the reference's
batches in the reference's order. Each pod sees a disjoint contiguous
shard of the stream (the FL property); the federated branch of
``launch/train.py`` stacks the pods' batches to ``(n_pods, B / n_pods,
S)``. ``shard_batch`` places a host batch onto a ``DeviceMesh`` as
DTensors, the batch dim over ``("pod", "data")``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import _dtensor
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import batch_axes


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


def shard_batch(batch: Dict[str, np.ndarray], mesh,
                spec: Optional[shd.P] = None) -> Dict[str, torch.Tensor]:
    """Place a host batch onto ``mesh``: DTensors on the mesh's device,
    the batch dim ``Shard(0)`` over ``("pod", "data")`` (those the mesh
    has, the pod axis major), or as ``spec`` says (the federated
    ``(n_pods, B / n_pods, S)`` stack: ``P("pod", "data")``). Every rank
    passes the same host batch and keeps its own rows."""
    if spec is None:
        spec = shd.P(batch_axes(mesh))
    placements = shd.to_placements(spec, mesh)
    return {k: _dtensor.place(torch.as_tensor(v, device=mesh.device_type),
                              mesh, placements)
            for k, v in batch.items()}
