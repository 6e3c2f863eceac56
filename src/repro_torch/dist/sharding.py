"""Partition rules for the ("pod", "data", "model") mesh.

The port's copy of the reference package's ``dist/sharding.py``: pure
spec logic keyed on parameter *path names* and shapes, with no device
state, so the same rules serve abstract meshes (the production shapes,
the tests) and a ``torch.distributed`` ``DeviceMesh`` alike. A mesh is
anything with ``axis_names`` and ``shape`` (a mapping of axis name to
size, as ``launch.mesh.AbstractMesh`` and JAX's meshes have), or a
``DeviceMesh`` (``mesh_dim_names`` and a tuple ``shape``).

The rules (Megatron conventions):

* **column-parallel** (default for matrices): shard the output features
  (last dim) over ``model``: ``wq``/``wk``/``wv``, MLP up/gate, SSD
  ``in_proj``, ...
* **row-parallel** for output projections (``wo``, ``w_down``,
  ``out_proj``, ``w_out``): shard the input features (dim -2) over
  ``model``, so the column-parallel activations before them feed them
  without a gather.
* **embeddings**: vocab-sharded over ``model`` where the vocab divides
  the axis, else ``d_model`` (mamba2's 50280 vocab is not 16-divisible).
* **MoE stacks**: expert-parallel (the expert dim over ``model``) where
  ``n_experts`` divides the axis (arctic's 128); else sharded within
  each expert like a plain matrix (mixtral's 8 < 16).
* **FSDP** (``cfg.fsdp``): also shard the other matrix dim over
  ``data``. ``opt_moment_specs`` gives the moments that treatment under
  ``cfg.zero_opt`` (ZeRO), even where the parameters are not sharded.
* **norm gains, biases and other vectors replicate.**

A leading ``units`` path entry marks the stacked-layer axis; it is never
sharded. A spec is a :class:`P`: a tuple of entries, each ``None``, an
axis name or a tuple of axis names, one a tensor dim (missing trailing
entries replicate). :func:`to_placements` turns one into the DTensor
placements of a ``DeviceMesh``.
"""
from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig

# output projections whose *input* features are model-sharded
ROW_PARALLEL = ("wo", "w_down", "out_proj", "w_out")
# vector-ish leaves that always replicate
REPLICATED = ("scale", "bias", "lam", "a_log", "dt_bias", "d_skip")


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``.

    One entry a tensor dim from the first; an entry is ``None``
    (replicated), an axis name, or a tuple of axis names (the dim split
    over those axes, the first major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(axis names, sizes)`` of an abstract mesh or a ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    shape = mesh.shape
    if hasattr(shape, "values"):
        return tuple(shape.keys()), tuple(int(s) for s in shape.values())
    return tuple(names), tuple(int(s) for s in shape)


def _axis_size(mesh, name: str) -> int:
    names, sizes = mesh_axes(mesh)
    return sizes[names.index(name)] if name in names else 1


def _axis_or_none(mesh, name: str):
    return name if name in mesh_axes(mesh)[0] else None


def _map_paths(fn, tree, prefix=()):
    """``fn(path names, leaf)`` over a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, tree[k], prefix + (str(k),))
                for k in sorted(tree)}
    return fn(list(prefix), tree)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------


def param_spec(
    path_names: Sequence[Any],
    shape: Tuple[int, ...],
    cfg: ModelConfig,
    mesh,
    *,
    fsdp: bool | None = None,
) -> P:
    """Spec of one parameter leaf.

    ``path_names`` is the tree path as strings (``["units", "b0",
    "mixer", "wq"]``), ``shape`` the full leaf shape (the stacked-units
    axis included). ``fsdp=None`` defers to ``cfg.fsdp``; an explicit
    bool overrides it (ZeRO moments).
    """
    names = [str(n) for n in path_names]
    leaf = names[-1] if names else ""
    ndim = len(shape)
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data")
    model_ax = _axis_or_none(mesh, "model")
    data_ax = _axis_or_none(mesh, "data")
    use_fsdp = bool(cfg.fsdp) if fsdp is None else bool(fsdp)
    lead = 1 if names and names[0] == "units" else 0

    # vectors, scalars, norm gains: replicate
    if (
        ndim - lead < 2
        or leaf in REPLICATED
        or any("norm" in n for n in names)
    ):
        return P(None)

    # embeddings / untied head: vocab-sharded with d_model fallback
    if leaf in ("embed", "lm_head"):
        v_ax, d_ax = (0, 1) if leaf == "embed" else (1, 0)
        entries: List[Any] = [None, None]
        if model_ax is not None and shape[v_ax] % model == 0:
            entries[v_ax] = model_ax
        elif model_ax is not None and shape[d_ax] % model == 0:
            entries[d_ax] = model_ax
        if use_fsdp and data_ax is not None:
            free = v_ax if entries[v_ax] is None else d_ax
            if entries[free] is None and shape[free] % data == 0:
                entries[free] = data_ax
        return P(*entries)

    # MoE expert stacks: expert-parallel when the axis divides, else
    # tensor-shard within each expert
    if cfg.moe is not None and "moe" in names and leaf in (
        "w_gate", "w_up", "w_down"
    ):
        E = cfg.moe.n_experts
        e_ax = next(
            (i for i in range(lead, ndim - 2) if shape[i] == E), None
        )
        if e_ax is not None:
            entries = [None] * ndim
            if model_ax is not None and E % model == 0:
                entries[e_ax] = model_ax
                if use_fsdp and data_ax is not None:
                    for i in range(e_ax + 1, ndim):
                        if shape[i] % data == 0:
                            entries[i] = data_ax
                            break
                return P(*entries)
            # fall through to the generic matrix rule below

    # generic matrices: column-parallel by default, row-parallel for
    # output projections; FSDP shards the other dim over data
    entries = [None] * ndim
    row = leaf in ROW_PARALLEL
    m_ax = ndim - 2 if row else ndim - 1
    f_ax = ndim - 1 if row else ndim - 2
    if model_ax is not None and shape[m_ax] % model == 0:
        entries[m_ax] = model_ax
    if (
        use_fsdp
        and data_ax is not None
        and f_ax >= lead
        and entries[f_ax] is None
        and shape[f_ax] % data == 0
    ):
        entries[f_ax] = data_ax
    return P(*entries)


def param_specs(params, cfg: ModelConfig, mesh, *, fsdp: bool | None = None):
    """Spec tree of a parameter tree (nested dicts of anything with a
    ``shape``), driven by the path names."""
    return _map_paths(
        lambda names, leaf: param_spec(names, tuple(leaf.shape), cfg, mesh,
                                       fsdp=fsdp),
        params)


def opt_moment_specs(moments, cfg: ModelConfig, mesh):
    """Specs of Adam/momentum moment trees (they mirror the params).

    With ``cfg.zero_opt`` the moments get the FSDP data-axis treatment
    even where the parameters are not FSDP-sharded: ZeRO partitioning
    of the optimizer state.
    """
    return param_specs(moments, cfg, mesh,
                       fsdp=bool(cfg.fsdp or cfg.zero_opt))


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def _batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The largest of ``("pod", "data")``, trimmed from the front, whose
    product divides ``batch``."""
    names = mesh_axes(mesh)[0]
    axes = [a for a in ("pod", "data") if a in names]
    while axes:
        prod = math.prod(_axis_size(mesh, a) for a in axes)
        if prod and batch % prod == 0:
            return tuple(axes)
        axes = axes[1:]  # drop the pod axis first, then data
    return ()


def _batch_entry(mesh, batch: int):
    axes = _batch_axes(mesh, batch)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def batch_spec(mesh, global_batch: int) -> P:
    """Spec of a ``(B, ...)`` batch: B over the pod and data axes."""
    entry = _batch_entry(mesh, global_batch)
    return P() if entry is None else P(entry)


def cache_specs(cache_shapes, cfg: ModelConfig, mesh, global_batch: int):
    """Specs of the serving cache tree of ``models.lm.init_cache``.

    The batch dim over the pod and data axes; the fused kv-head/feature
    dim of ``k``/``v`` (and the conv/recurrent states) over ``model``,
    matching the column-parallel projections so that decode never
    gathers the cache. SSD states shard their head dim instead
    (``d_state`` stays local to the chunk recurrence).
    """
    model = _axis_size(mesh, "model")
    model_ax = _axis_or_none(mesh, "model")
    b_entry = _batch_entry(mesh, global_batch)

    def spec(names, leaf):
        leaf_name = names[-1] if names else ""
        shape = tuple(getattr(leaf, "shape", ()))  # the port's pos: an int
        ndim = len(shape)
        if ndim == 0 or leaf_name == "pos":
            return P()
        lead = 1 if names and names[0] == "units" else 0
        entries: List[Any] = [None] * ndim
        if lead < ndim and b_entry is not None and shape[lead] == global_batch:
            entries[lead] = b_entry
        if model_ax is not None and ndim - lead >= 2:
            if leaf_name == "h" and ndim - lead == 4:
                # SSD state (B, n_heads, d_head, d_state): shard heads
                if shape[lead + 1] % model == 0:
                    entries[lead + 1] = model_ax
            elif leaf_name in ("k", "v", "conv", "h"):
                if shape[-1] % model == 0:
                    entries[-1] = model_ax
        return P(*entries)

    return _map_paths(spec, cache_shapes)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names that mesh dim, else
    ``Replicate()``. A tensor dim over several axes (``("pod",
    "data")``) is ``Shard(d)`` on each of them; DTensor splits by the
    mesh dims in order, which is the spec's major-to-minor order, so
    the axes of an entry must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axes(mesh)[0]
    placements: List[Any] = [Replicate()] * len(names)
    last = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(ax)
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"axis {ax!r} used twice in {spec!r}")
            if last.get(d, -1) > i:
                raise ValueError(
                    f"axes of dim {d} in {spec!r} are not in mesh order")
            last[d] = i
            placements[i] = Shard(d)
    return tuple(placements)


def spec_tree_placements(spec_tree, mesh):
    """:func:`to_placements` over a tree of specs."""
    return _map_paths(lambda _, s: to_placements(s, mesh), spec_tree)
