"""Fault-tolerant checkpointing: atomic, checksummed, background-capable.

The counterpart of the reference package's ``checkpoint/checkpoint.py``,
in its layout: an 8-byte little-endian length, a manifest (format
version, user metadata, and per leaf its path, shape, dtype name, crc32
and byte count), then the leaves' raw little-endian buffers in manifest
order. The reference packs the manifest with ``msgpack``; the port
writes it as UTF-8 JSON, so it needs no package beyond PyTorch and
numpy. Writes go to ``path + ".tmp"`` in the same directory, are
``fsync``'d and renamed over ``path`` with ``os.replace``, so a crash
mid-write never corrupts the latest checkpoint. A load verifies every
checksum.

A tree is nested dicts (keys in sorted order), tuples, lists and
NamedTuples (such as ``dist.stepfns.TrainState``) of tensors; a leaf's
path joins its keys, field names and indices with ``/``. The dtype name
is the tensor's (``bfloat16`` survives).
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import torch

_FORMAT_VERSION = 2


class CheckpointCorruption(RuntimeError):
    pass


def _flatten_with_paths(tree, prefix=""):
    """[(path, leaf)] in the tree's order: dicts by sorted key,
    NamedTuples by field, tuples and lists by index."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f in tree._fields
                for pl in _flatten_with_paths(getattr(tree, f), join(f))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten_with_paths(v, join(i))]
    return [(prefix, tree)]


def _unflatten(like, leaves: dict, prefix=""):
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, join(k)) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves, join(f))
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, join(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointCorruption(f"unknown dtype {name!r}")
    return dt


def _host(leaf) -> torch.Tensor:
    """A contiguous CPU copy of a leaf, not sharing its storage."""
    t = torch.as_tensor(leaf).detach()
    return t.to("cpu", copy=True).contiguous()


def _bytes(t: torch.Tensor):
    """A contiguous CPU tensor's raw bytes, a view of its storage."""
    return t.reshape(-1).view(torch.uint8).numpy()


def save(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Atomically write ``tree`` (a tree of tensors) to ``path``."""
    record = {"version": _FORMAT_VERSION, "metadata": metadata or {},
              "leaves": []}
    buffers = []
    for p, leaf in _flatten_with_paths(tree):
        # a contiguous CPU leaf (AsyncWriter's host copy) is written as
        # it is; any other is copied to the host once
        t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
        buf = _bytes(t)
        record["leaves"].append({
            "path": p,
            "shape": list(t.shape),
            "dtype": str(t.dtype).removeprefix("torch."),
            "crc32": zlib.crc32(buf),
            "nbytes": buf.nbytes,
        })
        buffers.append(buf)
    payload = json.dumps(record).encode("utf-8")
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(len(payload).to_bytes(8, "little"))
        f.write(payload)
        for buf in buffers:
            f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)   # atomic on POSIX


def load(path: str, like: Any = None) -> Tuple[Any, Dict]:
    """Load a checkpoint: ``(tree, metadata)``. With ``like`` the leaves
    are restored into its structure (paths must match), each cast to
    the dtype of ``like``'s leaf and placed on its device; without it
    the tree is a flat dict path -> CPU tensor. Raises
    ``CheckpointCorruption`` on a checksum mismatch, a short file or a
    missing leaf."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        record = json.loads(f.read(header_len).decode("utf-8"))
        arrays = {}
        for entry in record["leaves"]:
            # read into memory of PyTorch's allocator: its alignment, not
            # a bytes object's, so that kernels take the paths they take
            # on a freshly allocated tensor (same results bit for bit)
            buf = torch.empty(entry["nbytes"], dtype=torch.uint8)
            got = f.readinto(buf.numpy()) if entry["nbytes"] else 0
            if got != entry["nbytes"] or zlib.crc32(
                    buf.numpy()) != entry["crc32"]:
                raise CheckpointCorruption(
                    f"crc mismatch for leaf {entry['path']!r} in {path}")
            arrays[entry["path"]] = buf.view(
                _dtype(entry["dtype"])).reshape(entry["shape"])

    if like is None:
        return arrays, record["metadata"]
    want = _flatten_with_paths(like)
    missing = [p for p, _ in want if p not in arrays]
    if missing:
        raise CheckpointCorruption(f"missing leaves in {path}: "
                                   f"{missing[:5]}")
    out = {}
    for p, ref in want:
        arr = arrays[p]
        if isinstance(ref, torch.Tensor):
            arr = arr.to(device=ref.device, dtype=ref.dtype)
        out[p] = arr
    return _unflatten(like, out), record["metadata"]


class AsyncWriter:
    """Single-slot background writer: training never blocks on I/O.

    The tree is copied to the host when ``save`` is called, so training
    may go on with its tensors; a new save while the previous one is in
    flight waits for it (bounded memory). An error of the write is
    raised by the next ``wait`` or ``save``.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, tree: Any, metadata: Optional[Dict] = None):
        self.wait()
        host = _unflatten(tree, {p: _host(leaf) for p, leaf
                                 in _flatten_with_paths(tree)})

        def _run():
            try:
                save(path, host, metadata)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
