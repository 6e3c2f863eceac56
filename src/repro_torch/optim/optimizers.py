"""Optimizers as pure functions on parameter trees.

The counterparts of the reference package's ``optim/optimizers.py``:
the optimizer state mirrors the parameter tree leaf for leaf (nested
dicts of tensors, walked in sorted key order as ``jax.tree`` walks
them), ``state_dtype`` sets the moments' precision (bf16 moments halve
Adam's memory), and every update is computed in float32 in the
reference's order: the global-norm clip with ``+ 1e-9``, moments
``b·m + (1 − b)·g``, bias corrections ``1 − b ** step`` in float32,
``u + wd·p`` on leaves of two or more dimensions before ``p − lr·u``.
As in the reference, "two or more dimensions" is taken on the stored
leaf: a layer's norm vector stacked over ``n_units`` is 2-D and decays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.schedules import host_count, libm


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # "sgd" | "momentum" | "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: object           # first moment (or momentum buffer); (0,) for sgd
    nu: object           # second moment; (0,) leaves for sgd/momentum


def _first_leaf(tree) -> torch.Tensor:
    return tree_leaves(tree)[0]


def init_opt_state(params, cfg: OptimizerConfig) -> OptState:
    dt = torch_dtype(cfg.state_dtype)
    dev = _first_leaf(params).device

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device), params)

    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name in ("sgd", "momentum"):
        empty = tree_map(lambda p: torch.zeros((0,), dtype=dt,
                                               device=p.device), params)
        return OptState(step, zeros() if cfg.name == "momentum" else empty,
                        empty)
    return OptState(step, zeros(), zeros())


def _clip_by_global_norm(grads, max_norm: float):
    sq = sum(torch.sum(torch.square(g.float()))
             for g in tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def _powf(b: float, n: int) -> np.float32:
    """float32 ``b ** n`` as the reference's XLA CPU ``pow`` gives it:
    the C library's ``powf``, a subnormal result flushed to zero."""
    r = np.float32(libm().powf(float(np.float32(b)), float(np.float32(n))))
    return r if abs(r) >= np.finfo(np.float32).tiny else np.float32(0.0)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptimizerConfig,
                  lr: Optional[torch.Tensor] = None):
    """Returns ``(new_params, new_state, grad_norm)``; nothing is
    written in place."""
    lr = cfg.lr if lr is None else lr
    if cfg.grad_clip:
        grads, gnorm = _clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), device=state.step.device)
    step = state.step + 1
    sdt = torch_dtype(cfg.state_dtype)

    if cfg.name == "sgd":
        new_params = tree_map(
            lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
            params, grads)
        return new_params, OptState(step, state.mu, state.nu), gnorm

    if cfg.name == "momentum":
        mu = tree_map(lambda m, g: (0.9 * m.float() + g.float()).to(sdt),
                      state.mu, grads)
        new_params = tree_map(
            lambda p, m: (p.float() - lr * m.float()).to(p.dtype),
            params, mu)
        return new_params, OptState(step, mu, state.nu), gnorm

    # adamw; the bias corrections are scalars of the host's step count
    n = host_count(step)
    dev = step.device
    bc1 = torch.tensor(np.float32(1.0) - _powf(cfg.b1, n),
                       dtype=torch.float32, device=dev)
    bc2 = torch.tensor(np.float32(1.0) - _powf(cfg.b2, n),
                       dtype=torch.float32, device=dev)
    mu = tree_map(lambda m, g: (cfg.b1 * m.float()
                                + (1 - cfg.b1) * g.float()).to(sdt),
                  state.mu, grads)
    nu = tree_map(lambda v, g: (cfg.b2 * v.float()
                                + (1 - cfg.b2) * torch.square(g.float()))
                  .to(sdt), state.nu, grads)

    def upd(p, m, v):
        mhat = m.float() / bc1
        vhat = v.float() / bc2
        u = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:     # decay matrices only
            u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(step, mu, nu), gnorm
