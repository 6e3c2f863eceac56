"""Step functions of the port: the single-pod train step, serving, and
a pod update's wire size.

The counterparts of the reference package's ``dist/stepfns.py``
``TrainState``, ``init_train_state``, ``make_train_step``,
``make_prefill_step``, ``make_decode_step`` and ``fed_update_bits``.
There they are jitted and lowered onto meshes; here they run eagerly on
one device, and a step's gradients come from autograd (through the
kernels' ``autograd.Function``s on a card). The federated and async
steps (``make_fed_train_step``, ``make_fed_round_step``,
``make_async_round_step``) and ``grad_shardings``, a mesh concept, are
not ported yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import fedops
from repro_torch.models import lm
from repro_torch.optim.optimizers import (
    OptimizerConfig,
    OptState,
    apply_updates,
    init_opt_state,
)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Random parameters (``lm.init_params``: ``generator``, seed 0 if
    None) and a fresh optimizer state on ``device`` (the card if None)."""
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    params = lm.init_params(cfg, generator, dev)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg))


def _value_and_grad(params, cfg: ModelConfig, batch):
    """(loss, gradients) of ``lm.loss_fn`` at ``params``: autograd over
    leaves detached from ``params``; nothing is written in place."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = lm.loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    schedule: Optional[Callable] = None) -> Callable:
    """Single-pod step with microbatch gradient accumulation.

    ``step(state, batch) -> (state, metrics)`` where batch leaves are
    ``(B, ...)`` tensors on the state's device. With ``cfg.grad_accum >
    1`` the batch is split into ``grad_accum`` microbatches run in turn,
    their gradients summed in float32, divided by ``grad_accum`` and
    cast to the parameters' dtype, as the reference's scan body does.
    Metrics: ``loss``, ``grad_norm`` and ``lr`` (0-d tensors).
    """
    accum = max(int(cfg.grad_accum), 1)

    def step(state: TrainState, batch):
        if accum > 1:
            micro = [{k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()} for i in range(accum)]
            g_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=state.opt.step.device)
            for mb in micro:
                loss, g = _value_and_grad(state.params, cfg, mb)
                g_sum = tree_map(lambda a, b: a + b.to(a.dtype), g_sum, g)
                l_sum = l_sum + loss
            grads = tree_map(lambda g, p: (g / accum).to(p.dtype),
                             g_sum, state.params)
            loss = l_sum / accum
        else:
            loss, grads = _value_and_grad(state.params, cfg, batch)

        lr = (schedule(state.opt.step) if schedule is not None
              else torch.tensor(opt_cfg.lr, dtype=torch.float32,
                                device=state.opt.step.device))
        params, opt, gnorm = apply_updates(state.params, grads, state.opt,
                                           opt_cfg, lr=lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=params, opt=opt), metrics

    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``step(params, tokens, cache, extra_embeds=None) -> (logits, cache)``."""

    def step(params, tokens, cache, extra_embeds=None):
        return lm.prefill(params, cfg, tokens, cache, extra_embeds)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``step(params, token, cache) -> (logits, cache)`` — one token."""

    def step(params, token, cache):
        return lm.decode_step(params, cfg, token, cache)

    return step


def fed_update_bits(cfg: ModelConfig, compress: Optional[str] = "int8",
                    topk_frac: float = 0.05) -> int:
    """Wire bits of one pod's upload under ``compress`` (``M_i^UD``).

    The parameter tree is built under ``FakeTensorMode`` (shapes and
    dtypes, no storage) and counted by ``repro_torch.fl.compression``'s
    accounting, as the reference counts its ``eval_shape`` tree.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.fl.compression import (
        CompressorConfig,
        compressed_update_bits,
    )

    scheme = fedops.check_scheme(compress)
    with FakeTensorMode():
        params = lm.init_params(cfg, device="cpu")
    comp = CompressorConfig(scheme=scheme, topk_frac=topk_frac)
    return compressed_update_bits(params, comp)
