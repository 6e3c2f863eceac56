"""Carry the reference package's parameters into the port.

``from_reference_params`` takes the reference LM's parameter pytree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``),
with the leading ``n_units`` axis on the leaves of ``units``, and returns
the port's parameter dict with the same keys, shapes and dtypes, so that
both packages compute the same function in the tests. Every block kind
is carried: the MoE leaves (``router`` and the stacked ``w_gate``,
``w_up``, ``w_down``, each under the ``n_units`` axis) too, and
bfloat16 leaves (arctic-480b's ``param_dtype``) by their bits.
``from_reference_train_state`` carries a whole ``TrainState`` (params
and the optimizer's step and moments) across, so that both packages
run the same train step from the same state; a federated state (every
leaf under a leading ``n_pods`` axis, the step ``(n_pods,)``) too.
``from_reference_async_state`` carries the FedBuff round's
``AsyncRoundState`` (and error-feedback residuals) of such a state.
``cnn_params_from_reference`` does the same for the FL CNN's dict.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn, lm


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _convert(tree, want, path: str, device: torch.device):
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: keys {got} != "
                             f"{sorted(want)}")
        return {k: _convert(tree[k], want[k], f"{path}/{k}", device)
                for k in want}
    t = _tensor(tree)
    if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
        raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype} != "
                         f"{tuple(want.shape)} {want.dtype}")
    return t.to(device)


def from_reference_params(tree, cfg: ModelConfig,
                          device=DEFAULT_DEVICE) -> dict:
    """The port's params on ``device`` from a reference pytree of numpy
    arrays; raises ``ValueError`` if a key, shape or dtype does not match
    what ``lm.init_params(cfg)`` would build."""
    dev = resolve_device(device)
    want = lm._init(cfg, None, torch.device("meta"))
    return _convert(tree, want, "", dev)


def _want(cfg: ModelConfig, n_pods=None, dtype=None) -> dict:
    """The parameter tree ``lm.init_params(cfg)`` builds, on the meta
    device (no storage): under a leading ``n_pods`` axis if given, of
    ``dtype`` if given."""
    want = lm._init(cfg, None, torch.device("meta"))
    lead = () if n_pods is None else (n_pods,)
    return tree_map(lambda w: torch.empty(
        lead + tuple(w.shape), dtype=dtype or w.dtype, device="meta"), want)


def from_reference_train_state(state, cfg: ModelConfig,
                               device=DEFAULT_DEVICE):
    """The port's ``dist.stepfns.TrainState`` on ``device`` from the
    reference's ``TrainState`` as numpy (``jax.tree.map(np.asarray,
    state)``): ``params`` as :func:`from_reference_params` checks them,
    the optimizer's ``step`` as an int32 tensor and its ``mu``/``nu``
    trees leaf for leaf (their dtype is the optimizer's
    ``state_dtype``; sgd's and momentum's ``(0,)`` placeholders
    included). A federated state (``init_fed_state``'s: a ``(n_pods,)``
    step and every leaf under a leading ``n_pods`` axis) is carried as
    such. Raises ``ValueError`` where a key, shape or dtype does not
    match."""
    from repro_torch.dist.stepfns import TrainState
    from repro_torch.optim.optimizers import OptState

    dev = resolve_device(device)
    steps = np.asarray(state.opt.step)
    if steps.ndim > 1:
        raise ValueError(f"opt/step: shape {steps.shape} is neither () "
                         "nor (n_pods,)")
    n_pods = steps.shape[0] if steps.ndim == 1 else None
    lead = () if n_pods is None else (n_pods,)
    want = _want(cfg, n_pods)

    def moments(tree, like, path):
        if isinstance(like, dict):
            if not isinstance(tree, dict) or set(tree) != set(like):
                raise ValueError(f"{path}: keys do not match the "
                                 "parameters'")
            return {k: moments(tree[k], like[k], f"{path}/{k}")
                    for k in like}
        t = _tensor(tree)
        if tuple(t.shape) not in (tuple(like.shape), lead + (0,)):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
        return t.to(dev)

    step = torch.from_numpy(steps.astype(np.int32)).to(dev)
    opt = OptState(step, moments(state.opt.mu, want, "mu"),
                   moments(state.opt.nu, want, "nu"))
    return TrainState(params=_convert(state.params, want, "", dev),
                      opt=opt)


def from_reference_async_state(astate, cfg: ModelConfig,
                               device=DEFAULT_DEVICE, residuals=None):
    """The port's ``dist.stepfns.AsyncRoundState`` on ``device`` from the
    reference's as numpy: ``global_params`` and ``refs`` pod-stacked
    parameter trees, ``pending`` their float32 deltas. With
    ``residuals`` (the reference's error-feedback residuals, pod-stacked
    float32) returns ``(astate, residuals)``. Raises ``ValueError``
    where a key, shape or dtype does not match."""
    from repro_torch.dist.stepfns import AsyncRoundState

    dev = resolve_device(device)
    lead = np.asarray(tree_leaves(astate.global_params)[0]).shape[:1]
    if not lead:
        raise ValueError("global_params: no leading pod axis")
    want = _want(cfg, lead[0])
    want32 = _want(cfg, lead[0], torch.float32)
    out = AsyncRoundState(
        global_params=_convert(astate.global_params, want, "global", dev),
        refs=_convert(astate.refs, want, "refs", dev),
        pending=_convert(astate.pending, want32, "pending", dev))
    if residuals is None:
        return out
    return out, _convert(residuals, want32, "residuals", dev)


def cnn_params_from_reference(tree, device=DEFAULT_DEVICE) -> dict:
    """The port's CNN params on ``device`` from the reference's CNN
    params (the paper's model: 62 classes, width 1) as nested dicts of
    numpy arrays; raises ``ValueError`` if a key, shape or dtype does not
    match what ``cnn.init_params`` would build."""
    dev = resolve_device(device)
    want = cnn._init(None, cnn.N_CLASSES, 1, torch.device("meta"))
    return _convert(tree, want, "", dev)
