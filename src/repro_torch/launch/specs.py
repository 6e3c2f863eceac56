"""Input specs for every (arch x input shape x step): shape, dtype and
partition spec of each leaf, with no storage.

The counterpart of the reference package's ``launch/specs.py``. The
parameter, optimizer and cache shapes come from the port's real init
functions on the meta device (where the reference runs
``jax.eval_shape``); the partition specs from ``dist.sharding``. A
:class:`TensorSpec` plays the part of ``jax.ShapeDtypeStruct`` with its
sharding; ``sharding.to_placements`` turns a spec into the DTensor
placements of a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import _dtensor
from repro_torch._tree import tree_map
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.dist.stepfns import (
    TrainState,
    init_fed_state,
    init_train_state,
)
from repro_torch.models import lm
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.optimizers import OptimizerConfig, OptState


class TensorSpec(NamedTuple):
    """A leaf's global shape, dtype and partition spec."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: P


def _with_specs(shape_tree, spec_tree):
    """TensorSpecs of a tree of shaped leaves (dicts, NamedTuples) and
    its spec tree."""
    return tree_map(lambda t, s: TensorSpec(tuple(t.shape), t.dtype, s),
                    shape_tree, spec_tree)


# ---------------------------------------------------------------------------
# state specs
# ---------------------------------------------------------------------------


def state_shapes(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                 n_pods: int = 0) -> TrainState:
    """The train state (pod-stacked over ``n_pods`` if given) as meta
    tensors: shapes and dtypes, no storage."""
    meta = torch.device("meta")
    if n_pods:
        return init_fed_state(cfg, opt_cfg, n_pods, device=meta)
    return init_train_state(cfg, opt_cfg, device=meta)


def state_spec_tree(state_shape: TrainState, cfg: ModelConfig, mesh,
                    fed: bool = False) -> TrainState:
    """Spec tree matching a ``TrainState`` of shapes; with ``fed`` the
    leaves' leading pod axis is sharded over ``pod``."""
    strip = 1 if fed else 0

    def despecced(leaf):
        return torch.empty(tuple(leaf.shape)[strip:], dtype=leaf.dtype,
                           device="meta")

    def podded(spec: P) -> P:
        return P(*(("pod",) + tuple(spec))) if fed else spec

    def specs_of(tree, rule):
        inner = tree_map(despecced, tree)
        return tree_map(podded, rule(inner, cfg, mesh))

    return TrainState(
        params=specs_of(state_shape.params, shd.param_specs),
        opt=OptState(step=P("pod") if fed else P(),
                     mu=specs_of(state_shape.opt.mu, shd.opt_moment_specs),
                     nu=specs_of(state_shape.opt.nu, shd.opt_moment_specs)))


def state_specs(cfg: ModelConfig, opt_cfg: OptimizerConfig, mesh,
                fed: bool = False, n_pods: int = 0):
    """``(TensorSpec tree, spec tree)`` of the train state."""
    shapes = state_shapes(cfg, opt_cfg, n_pods if fed else 0)
    specs = state_spec_tree(shapes, cfg, mesh, fed=fed)
    return _with_specs(shapes, specs), specs


# ---------------------------------------------------------------------------
# batch / serving input specs
# ---------------------------------------------------------------------------


def _mesh_size(mesh, name: str) -> int:
    names, sizes = shd.mesh_axes(mesh)
    return sizes[names.index(name)]


def train_batch_specs(cfg: ModelConfig, shape: InputShape, mesh,
                      fed: bool = False, n_pods: int = 0) -> Dict[str, Any]:
    """TensorSpecs of a training batch: ``tokens`` and ``labels`` (and a
    frontend's ``extra_embeds``), ``(B, S)``; with ``fed`` stacked to
    ``(n_pods, B / n_pods, ...)``, the pod axis over ``pod`` and the
    per-pod batch over ``data`` where it divides."""
    B, S = shape.global_batch, shape.seq_len
    n_front = cfg.n_frontend_tokens
    s_text = S - n_front
    bspec = shd.batch_spec(mesh, B)
    batch = {
        "tokens": TensorSpec((B, s_text), torch.int32, bspec),
        "labels": TensorSpec((B, s_text), torch.int32, bspec),
    }
    if cfg.frontend:
        fspec = P(*(tuple(bspec) + (None, None))) if tuple(bspec) else P()
        batch["extra_embeds"] = TensorSpec(
            (B, n_front, cfg.d_model), torch_dtype(cfg.dtype), fspec)
    if fed:
        names = shd.mesh_axes(mesh)[0]

        def podify(ts: TensorSpec) -> TensorSpec:
            per_pod = ts.shape[0] // n_pods
            data_ok = ("data" in names
                       and per_pod % _mesh_size(mesh, "data") == 0)
            spec = P("pod", "data" if data_ok else None,
                     *((None,) * (len(ts.shape) - 1)))
            return TensorSpec((n_pods, per_pod) + ts.shape[1:], ts.dtype,
                              spec)

        batch = {k: podify(v) for k, v in batch.items()}
    return batch


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh):
    """``(TensorSpec tree, spec tree)`` of the serving cache; ``pos`` (an
    int in the port's cache) is a 0-d int32 leaf here, as in the
    reference's."""
    shapes = lm.init_cache(cfg, batch, max_len, device="meta")
    shapes["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    spec_tree = shd.cache_specs(shapes, cfg, mesh, batch)
    return _with_specs(shapes, spec_tree), spec_tree


def decode_input_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """``(token, cache, cache specs)`` of ``decode_step``: the token at
    position ``seq_len - 1``."""
    B = shape.global_batch
    cache, cache_spec = cache_specs(cfg, B, shape.seq_len, mesh)
    token = TensorSpec((B, 1), torch.int32, shd.batch_spec(mesh, B))
    return token, cache, cache_spec


def prefill_input_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """``(tokens, cache, cache specs, extra_embeds or None)`` of
    ``prefill``."""
    B, S = shape.global_batch, shape.seq_len
    n_front = cfg.n_frontend_tokens
    bspec = shd.batch_spec(mesh, B)
    tokens = TensorSpec((B, S - n_front), torch.int32, bspec)
    cache, cache_spec = cache_specs(cfg, B, S, mesh)
    extra = None
    if cfg.frontend:
        fspec = P(*(tuple(bspec) + (None, None))) if tuple(bspec) else P()
        extra = TensorSpec((B, n_front, cfg.d_model),
                           torch_dtype(cfg.dtype), fspec)
    return tokens, cache, cache_spec, extra


def place_tree(tree, spec_tree, mesh):
    """A tree of whole tensors (the same on every rank) as DTensors on
    ``mesh``, each placed by its spec; each rank keeps its own part, with
    no communication. ``TrainState``s and ``OptState``s are walked too."""
    return tree_map(
        lambda t, s: _dtensor.place(t, mesh, shd.to_placements(s, mesh)),
        tree, spec_tree)
