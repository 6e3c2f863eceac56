"""Client-side local training executor (generic over model via loss_fn).

Local minibatch SGD through torch autograd, with the reference's
momentum branch. The client's numpy data move to the parameters' device
once; each epoch draws one ``rng.permutation``, as the reference does, so
a shared ``rng`` stays in step with it. Steps run in full float32
(``full_float32``, around the backward too).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch._device import full_float32
from repro_torch._tree import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class LocalTrainConfig:
    lr: float = 0.05
    batch_size: int = 32
    local_epochs: int = 1
    momentum: float = 0.0


def _sgd_step(params, velocity, batch, loss_fn, lr, momentum):
    """One step: ``(params, velocity, loss)``; ``velocity`` is None
    without momentum."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    if momentum:
        grads = [momentum * v + g
                 for v, g in zip(tree_leaves(velocity), grads)]
        velocity = tree_unflatten(velocity, grads)
    new = [p.detach() - lr * g for p, g in zip(live, grads)]
    return tree_unflatten(params, new), velocity, loss.detach()


class Client:
    """One FL client: local data + local SGD. Failure injection for FT tests."""

    def __init__(
        self,
        client_id: int,
        data: Dict[str, np.ndarray],
        loss_fn: Callable,
        cfg: LocalTrainConfig,
        t_ud_s: float = 1.0,
        distance_m: float = 20_000.0,
    ):
        self.client_id = client_id
        self.data = data
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.t_ud_s = t_ud_s            # heterogeneous compute time (paper)
        self.distance_m = distance_m
        self._on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    @property
    def n_samples(self) -> int:
        return len(next(iter(self.data.values())))

    def _data_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._on_device:
            self._on_device[device] = {
                k: torch.as_tensor(v, device=device)
                for k, v in self.data.items()}
        return self._on_device[device]

    def train(self, global_params, rng: np.random.Generator):
        """Run local epochs of minibatch SGD from the global model.
        Returns (params on the global model's device, mean loss)."""
        device = tree_leaves(global_params)[0].device
        data = self._data_on(device)
        params = global_params
        velocity = (tree_unflatten(global_params, [
            torch.zeros_like(p) for p in tree_leaves(global_params)])
            if self.cfg.momentum else None)
        n = self.n_samples
        bs = min(self.cfg.batch_size, n)
        losses = []
        with full_float32():
            for _ in range(self.cfg.local_epochs):
                order = torch.as_tensor(rng.permutation(n), device=device)
                for start in range(0, n - bs + 1, bs):
                    idx = order[start : start + bs]
                    batch = {k: v[idx] for k, v in data.items()}
                    params, velocity, loss = _sgd_step(
                        params, velocity, batch, self.loss_fn,
                        self.cfg.lr, self.cfg.momentum,
                    )
                    losses.append(float(loss))
        return params, float(np.mean(losses)) if losses else 0.0
