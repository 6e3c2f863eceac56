"""DTensor helpers of the port: tensors placed on a ``DeviceMesh``.

The mesh path of training (``launch/train.py`` with ``dist/stepfns.py``)
holds its state and batches as DTensors, placed by ``dist/sharding.py``'s
rules; the model's code runs on them unchanged, DTensor's sharding
propagation deciding the collectives. These helpers are the few places
where the port steps out of that:

* :func:`local_kernel` runs a kernel's dispatch (K4, K5, K6: CUDA
  extensions inside ``torch.autograd.Function``s that take plain tensors)
  on each rank's local part of DTensor inputs, as
  ``torch.distributed.tensor.experimental.local_map`` does;
* :func:`full` and :func:`place_like` move between a DTensor and the
  whole tensor (checkpoints, the state ``train()`` returns);
* :func:`mesh_context` lets plain tensors made inside a step (positions,
  masks, scalars) meet DTensors as replicated values.

Nothing here runs unless a DTensor is passed in; plain tensors take the
code paths they took before.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full(x):
    """The whole tensor behind ``x`` (a DTensor's ``full_tensor()``; on a
    mesh of one device its local tensor, no copy); ``x`` if plain."""
    if not is_dtensor(x):
        return x
    if x.device_mesh.size() == 1:
        return x.to_local()
    return x.full_tensor()


def local(x):
    """A DTensor's local tensor; ``x`` if plain."""
    return x.to_local() if is_dtensor(x) else x


def place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor ``t``, the same on every rank, as a DTensor with
    ``placements``: each rank keeps its part, with no communication."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)


def place_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` placed as the DTensor ``like`` is; ``t`` if ``like`` is
    plain."""
    if not is_dtensor(like):
        return t
    return place(t, like.device_mesh, like.placements)


def whole_dim(x, dim: int):
    """A DTensor made whole along ``dim`` on every rank (a split of that
    dim gathered, a partial sum reduced; other splits kept); ``x`` if
    plain."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    d = dim % x.dim()
    pl = [p if isinstance(p, Shard) and p.dim % x.dim() != d
          else Replicate() if not isinstance(p, Replicate) else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def unflatten(x, dim: int, sizes: Sequence[int]):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape). A DTensor
    whose ``dim`` is split over mesh dims that do not divide ``sizes[0]``
    (8 kv heads over a 16-way ``model`` axis) is made whole along ``dim``
    first, as DTensor cannot split such a dim in place."""
    d = dim % x.dim()
    if is_dtensor(x):
        from torch.distributed.tensor import Shard

        n = 1
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim % x.dim() == d:
                n *= x.device_mesh.size(m)
        if sizes[0] % n:
            x = whole_dim(x, d)
    return x.reshape(tuple(x.shape[:d]) + tuple(sizes)
                     + tuple(x.shape[d + 1:]))


class _Merge(torch.autograd.Function):
    """Dims ``dim`` up to ``dim + n`` merged into one; the gradient split
    back by :func:`unflatten`."""

    @staticmethod
    def forward(ctx, x, dim: int, n: int):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + n])
        return x.flatten(dim, dim + n - 1)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, ctx.sizes), None, None


def merge(x, dim: int, n: int):
    """``x`` with its dims ``dim`` up to ``dim + n`` merged into one (a
    reshape). On a DTensor the gradient is split back with
    :func:`unflatten`, so that a split the heads do not divide is
    gathered rather than refused."""
    d = dim % x.dim()
    if is_dtensor(x):
        return _Merge.apply(x, d, n)
    return x.reshape(tuple(x.shape[:d]) + (-1,) + tuple(x.shape[d + n:]))


class _Unbind(torch.autograd.Function):
    """``torch.unbind`` of a DTensor along dim 0. The backward stacks the
    slices' gradients as ``unbind``'s does; where, on one mesh dim, some
    came back partial and some split, which DTensor cannot stack, each is
    first placed as its slice is."""

    @staticmethod
    def forward(ctx, x):
        outs = torch.unbind(x)
        ctx.placements = [o.placements for o in outs]
        return outs

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import Partial, Shard

        some = next(g for g in grads if g is not None)
        grads = [torch.zeros_like(some) if g is None else g for g in grads]
        mixed = any(
            any(isinstance(g.placements[m], Partial) for g in grads)
            and any(isinstance(g.placements[m], Shard) for g in grads)
            for m in range(some.device_mesh.ndim))
        if mixed:
            grads = [g.redistribute(g.device_mesh, pl)
                     for g, pl in zip(grads, ctx.placements)]
        return torch.stack(grads)


def unbind(x) -> tuple:
    """``torch.unbind(x)`` (dim 0); on a DTensor through :class:`_Unbind`,
    whose backward stacks gradients of mixed placements."""
    if is_dtensor(x):
        return _Unbind.apply(x)
    return torch.unbind(x)


def mesh_context(*tensors):
    """``implicit_replication()`` where any of ``tensors`` is a DTensor
    (plain tensors then join DTensor ops as replicated), else a no-op."""
    if any(is_dtensor(t) for t in tensors):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def local_kernel(fn: Callable, args: Sequence, dims: Sequence,
                 out_dims):
    """``fn(*args)`` on each rank's local part of the DTensors in
    ``args``, the result DTensors again.

    ``dims[i]`` names the dims of ``args[i]`` that a kernel may see split
    across ranks (``{0: "batch", 2: "head"}``), ``out_dims`` those of the
    output (a dict, or a tuple of dicts for a tuple of outputs). A mesh
    dim stays split where the DTensor arguments that are split on it all
    split a dim of one name, and those that are not hold no dim of that
    name (K5's ``B``/``C`` beside heads split over ``model``); on any
    other mesh dim every argument is gathered first (``Replicate``).
    Plain arguments pass through; gradients flow through
    ``to_local``/``from_local``, an argument's gradient a partial sum on
    the mesh dims that split a dim it does not hold (K5's ``a`` over the
    batch)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    idx = [i for i, a in enumerate(args) if is_dtensor(a)]
    mesh = args[idx[0]].device_mesh
    want = {i: list(args[i].placements) for i in idx}
    kept = []                      # the name a mesh dim splits, or None
    sizes = {}                     # name -> the output's global size
    for i in idx:                  # of it: the first argument's (K4's q)
        for d, name in dims[i].items():
            sizes.setdefault(name, args[i].shape[d])
    for m in range(mesh.ndim):
        names = set()
        for i in idx:
            p = want[i][m]
            if isinstance(p, Shard):
                names.add(dims[i].get(p.dim % args[i].dim()))
            elif not isinstance(p, Replicate):
                names.add(None)
        name = names.pop() if len(names) == 1 else None
        ok = name is not None and all(
            isinstance(want[i][m], Shard)
            or name not in dims[i].values() for i in idx)
        kept.append(name if ok else None)
        if not ok:
            for i in idx:
                want[i][m] = Replicate()
    local = list(args)
    for i in idx:
        a = args[i]
        if list(a.placements) != want[i]:
            a = a.redistribute(mesh, want[i])
        grad_pl = [Partial() if n is not None and n not in dims[i].values()
                   else p for n, p in zip(kept, want[i])]
        local[i] = a.to_local(grad_placements=grad_pl)
    out = fn(*local)

    def wrap(t, names: dict):
        at = {v: k for k, v in names.items()}
        pl = [Replicate() if n is None else Shard(at[n]) for n in kept]
        shape = [sizes[names[d]] if d in names else t.shape[d]
                 for d in range(t.dim())]
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_strides(shape))

    if isinstance(out, tuple):
        return tuple(wrap(t, n) for t, n in zip(out, out_dims))
    return wrap(out, out_dims)


def contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))
