"""Meshes of the port: the production shapes and a host mesh over the
ranks of a ``torch.distributed`` job.

The counterpart of the reference package's ``launch/mesh.py``: single
pod 16x16 = 256 devices ``("data", "model")``, multi-pod 2x16x16 = 512
``("pod", "data", "model")``. The ``pod`` axis is the federated axis,
one pod per EC-node site in the paper's mapping. A real mesh is a
``torch.distributed`` ``DeviceMesh`` over the job's ranks (one rank a
device, on the device type the caller names); :class:`AbstractMesh`
holds axis names and sizes alone, with no process group, for the spec
rules and the production shapes on a machine that does not have their
ranks. Importing this module touches no device and no process group.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh:
    """Axis names and sizes of a mesh with no devices behind it.
    ``shape`` maps each axis name to its size, in mesh order."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} against axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names,
                                     (int(s) for s in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(self.shape)})"


# the backend a mesh's collectives need on each device type
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _check_backend(device_type: str) -> None:
    """Raise unless the default process group serves ``device_type``
    with its backend (``nccl`` for the cards, ``gloo`` for the CPU)."""
    import torch.distributed as dist

    want = _BACKEND.get(device_type)
    if want is None:
        raise ValueError(f"no mesh on {device_type!r}; use cuda or cpu")
    served = {}
    for part in dist.get_backend_config().split(","):
        dev, _, backend = part.rpartition(":")
        served[dev or device_type] = backend
    if served.get(device_type) != want:
        raise ValueError(
            f"a {device_type} mesh needs a {want} process group; the "
            f"running one serves {dist.get_backend_config()!r}")


def _init_mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _check_backend(device_type)
    n = dist.get_world_size()
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {total} "
                         f"ranks; the process group has {n}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axis names and sizes (no process group
    needed)."""
    return AbstractMesh(*PRODUCTION[bool(multi_pod)])


def make_host_mesh(model_parallel: int = 1, pods: int = 1,
                   pod_axis: bool | None = None, device="cuda"):
    """A ``DeviceMesh`` on ``device``'s type (``"cuda"`` or ``"cpu"``)
    over every rank of the default process group, whose backend must
    serve it (``ValueError`` otherwise): ``(pods, data, model_parallel)``
    over ``("pod", "data", "model")`` with ``data = ranks //
    (model_parallel * pods)``, or ``(data, model_parallel)`` over
    ``("data", "model")`` without a pod axis. ``pod_axis`` defaults to
    ``pods > 1``; pass True to keep a pod axis of size 1 (several pods
    stacked on every rank)."""
    import torch
    import torch.distributed as dist

    device_type = torch.device(device).type
    n = dist.get_world_size()
    data = n // (model_parallel * pods)
    if pod_axis is None:
        pod_axis = pods > 1
    if pod_axis:
        return _init_mesh((pods, data, model_parallel),
                          ("pod", "data", "model"), device_type)
    return _init_mesh((data, model_parallel), ("data", "model"), device_type)


def batch_axes(mesh) -> tuple:
    """The mesh's batch axes: those of ``("pod", "data")`` it has."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)
