"""The port's checkpoints (``repro_torch.checkpoint``), on the CPU.

A ``TrainState`` of float32, bf16 and int32 leaves (and sgd's empty
moments) survives a save and a load bit for bit, into its structure and
dtypes; the manifest is JSON (no ``msgpack``) after an 8-byte length, in
the reference's layout; a flipped byte raises ``CheckpointCorruption``;
a crash mid-write leaves the ``.tmp`` and the previous file whole; the
manager keeps ``keep`` files, skips a corrupt newest one on restore, and
its background writer copies the tree when called and surfaces a
failed write on ``wait``.
"""
import json
import os

import pytest
import torch

from repro_torch.checkpoint import (
    AsyncWriter,
    CheckpointCorruption,
    CheckpointManager,
    load,
    save,
)
from repro_torch.configs import get_config
from repro_torch.dist import stepfns
from repro_torch.optim import OptimizerConfig
from repro_torch._tree import tree_leaves, tree_map


def _state(name="adamw", state_dtype="float32", param_dtype="float32",
           seed=0):
    """A smoke olmo-1b TrainState at step 7 with random moments."""
    cfg = get_config("olmo-1b", smoke=True).replace(param_dtype=param_dtype)
    gen = torch.Generator().manual_seed(seed)
    state = stepfns.init_train_state(
        cfg, OptimizerConfig(name=name, state_dtype=state_dtype), gen,
        device="cpu")

    def fill(m):
        return torch.randn(m.shape, generator=gen).to(m.dtype)

    opt = state.opt._replace(step=torch.tensor(7, dtype=torch.int32),
                             mu=tree_map(fill, state.opt.mu),
                             nu=tree_map(fill, state.opt.nu))
    return state._replace(opt=opt)


def _equal(a, b):
    la, lb = tree_leaves(a.params), tree_leaves(b.params)
    la += [a.opt.step] + tree_leaves(a.opt.mu) + tree_leaves(a.opt.nu)
    lb += [b.opt.step] + tree_leaves(b.opt.mu) + tree_leaves(b.opt.nu)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("name,state_dtype,param_dtype", [
    ("adamw", "float32", "float32"), ("adamw", "bfloat16", "bfloat16"),
    ("sgd", "float32", "bfloat16")])
def test_round_trip_bit_for_bit(tmp_path, name, state_dtype, param_dtype):
    state = _state(name, state_dtype, param_dtype)
    path = str(tmp_path / "a.ckpt")
    save(path, state, metadata={"round": 3, "note": "x"})
    like = _state(name, state_dtype, param_dtype, seed=1)
    got, meta = load(path, like=like)
    assert meta == {"round": 3, "note": "x"}
    assert isinstance(got, stepfns.TrainState)
    assert _equal(got, state)
    flat, _ = load(path)
    assert flat["params/embed"].dtype == state.params["embed"].dtype
    assert flat["opt/step"].dtype == torch.int32
    assert torch.equal(flat["params/embed"], state.params["embed"])


def test_manifest_layout(tmp_path):
    path = str(tmp_path / "a.ckpt")
    save(path, {"w": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                "h": torch.ones(2, dtype=torch.bfloat16)}, {"k": 1})
    raw = open(path, "rb").read()
    n = int.from_bytes(raw[:8], "little")
    record = json.loads(raw[8:8 + n])
    assert record["version"] == 2 and record["metadata"] == {"k": 1}
    assert [(e["path"], e["shape"], e["dtype"], e["nbytes"])
            for e in record["leaves"]] == [("h", [2], "bfloat16", 4),
                                           ("w", [2, 3], "int32", 24)]
    body = raw[8 + n:]
    assert body[4:] == torch.arange(6, dtype=torch.int32).numpy().tobytes()


def test_corruption_raises(tmp_path):
    path = str(tmp_path / "a.ckpt")
    save(path, _state())
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruption, match="crc mismatch"):
        load(path, like=_state())
    save(path, {"a": torch.zeros(2)})
    with pytest.raises(CheckpointCorruption, match="missing leaves"):
        load(path, like={"a": torch.zeros(2), "b": torch.zeros(1)})


def test_crash_mid_write_keeps_the_previous_file(tmp_path, monkeypatch):
    path = str(tmp_path / "a.ckpt")
    first = _state(seed=0)
    save(path, first, {"round": 1})

    def crash(fd):
        raise OSError("disk gone")

    monkeypatch.setattr(os, "fsync", crash)
    with pytest.raises(OSError, match="disk gone"):
        save(path, _state(seed=1), {"round": 2})
    assert os.path.exists(path + ".tmp")
    got, meta = load(path, like=first)
    assert meta == {"round": 1} and _equal(got, first)


def test_manager_rotation_and_restore(tmp_path):
    states = {s: _state(seed=s) for s in (1, 2, 3)}
    # the background writer's file lands after that save's rotation, so
    # a save rotates away what the files finished before it exceed
    # (as in the reference)
    mgr = CheckpointManager(str(tmp_path / "async"), keep=2)
    for s, st in states.items():
        mgr.save(s, st, {"round": s})
        mgr.wait()
    assert mgr.all_steps() == [1, 2, 3]
    mgr.save(4, states[1])
    mgr.wait()
    assert mgr.all_steps() == [2, 3, 4]
    mgr = CheckpointManager(str(tmp_path), keep=2, use_async=False)
    for s, st in states.items():
        mgr.save(s, st, {"round": s})
    assert mgr.all_steps() == [2, 3]
    got, meta = mgr.restore_latest(like=states[1])
    assert meta == {"round": 3, "step": 3} and _equal(got, states[3])
    # a corrupt newest file is skipped
    newest = os.path.join(str(tmp_path), "step_3.ckpt")
    raw = bytearray(open(newest, "rb").read())
    raw[-1] ^= 0x01
    open(newest, "wb").write(bytes(raw))
    got, meta = mgr.restore_latest(like=states[1])
    assert meta["step"] == 2 and _equal(got, states[2])
    # a truncated newest file too
    open(newest, "wb").write(bytes(raw[:100]))
    assert mgr.restore_latest(like=states[1])[1]["step"] == 2
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() is None


def test_async_writer_copies_on_call_and_surfaces_errors(tmp_path):
    w = AsyncWriter()
    t = {"a": torch.arange(4.0)}
    path = str(tmp_path / "a.ckpt")
    w.save(path, t, {"r": 0})
    t["a"].add_(100.0)              # training goes on with the tensor
    w.wait()
    got, _ = load(path, like={"a": torch.zeros(4)})
    assert torch.equal(got["a"], torch.arange(4.0))
    w.save(str(tmp_path / "no" / "such" / "\0bad"), t)
    with pytest.raises(ValueError):
        w.wait()
    w.wait()                        # the error is raised once
