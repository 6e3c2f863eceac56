"""The port's training driver (``repro_torch.launch.train``) against the
JAX package's ``launch/train.py``, on the CPU.

* ``train()`` at smoke size (olmo-1b, 2 rounds x 2 steps, batch 4, seq
  16, one pod) on both packages, the port's ``init_train_state``
  replaced by the reference's state carried across (test only): every
  round's ``sync_s`` bit for bit, every round's loss within
  ``LOSS_RTOL``, the final parameters within ``PARAM_ATOL``, and the
  same ``--log-jsonl`` events (kinds, order, keys; the metrics summary's
  keys too).
* A resumed run (only round 2's checkpoint copied into a fresh
  directory) lands on the uninterrupted port run's final state bit for
  bit, and its events say where it resumed (under PyTorch's
  deterministic algorithms: see the fixture).
* ``pods > 1`` raises ``NotImplementedError`` exactly where the
  reference's pod formula (``src/repro/launch/train.py:103``) takes the
  federated path, and nowhere else.
* ``chip_smoke.TRAIN_SYNC_PINS`` recomputed with the JAX package's
  engine (the payload bits of the full-width trees, counted by the
  reference's ``compressed_update_bits`` on the port's shapes), and the
  port's own timeline on the CPU at those pins, bit for bit.
"""
import importlib.util
import json
import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core.slicing import ClientProfile as JClientProfile
from repro.dist import stepfns as jstep
from repro.fl.compression import CompressorConfig, compressed_update_bits
from repro.launch import train as jtrain
from repro.net.api import SweepSpec as JSweepSpec
from repro.net.api import simulate as jsimulate
from repro.net.engine import SweepCase as JSweepCase
from repro.net.sim import FLRoundWorkload as JWorkload
from repro.net.sim import PONConfig as JPON
from repro.net.timeline import TimelineSchedule as JSchedule
from repro.optim import optimizers as jopt
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import lm
from repro_torch.models.convert import from_reference_train_state
from repro_torch.net.api import simulate as tsimulate

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5      # float32 losses after 4 AdamW steps
PARAM_ATOL = 1e-6     # float32 parameters of order 1 after 4 steps
KW = dict(arch="olmo-1b", smoke=True, steps_per_round=2, rounds=2,
          n_pods=1, global_batch=4, seq_len=16, log_every=1)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _shape(ev: dict) -> tuple:
    keys = tuple(sorted(ev))
    if ev["event"] == "metrics":
        keys += tuple(sorted(ev["summary"]))
    return ev["event"], keys


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ev.jsonl")
    state, history = jtrain.train(log_jsonl=path, **KW)
    return jax.tree.map(np.asarray, state), history, _events(path)


def _reference_state(cfg):
    jcfg = jtrain.get_config(KW["arch"], smoke=True).replace(grad_accum=1)
    state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg,
                                   jopt.OptimizerConfig(name="adamw",
                                                        lr=3e-3))
    return from_reference_train_state(jax.tree.map(np.asarray, state), cfg,
                                      device="cpu")


def test_train_equals_reference(reference_run, tmp_path, monkeypatch):
    want_state, want_hist, want_events = reference_run
    monkeypatch.setattr(ttrain.stepfns, "init_train_state",
                        lambda cfg, opt_cfg, device=None:
                        _reference_state(cfg))
    path = str(tmp_path / "ev.jsonl")
    state, history = ttrain.train(log_jsonl=path, device="cpu", **KW)
    assert [h["round"] for h in history] == [h["round"] for h in want_hist]
    for got, want in zip(history, want_hist):
        assert got["sync_s"] == want["sync_s"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
    flat = jax.tree_util.tree_flatten_with_path(want_state.params)[0]
    for (p, w), g in zip(flat, tree_leaves(state.params)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(p))
    got_events = _events(path)
    assert [_shape(e) for e in got_events] == [_shape(e)
                                               for e in want_events]
    assert got_events[0]["shape"] == want_events[0]["shape"]


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for one test: on the CPU the
    embedding's backward (``index_put_`` with accumulation) adds in a
    thread-dependent order otherwise, so two runs of one training differ
    in the last bits."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def test_resume_reproduces_the_uninterrupted_run(tmp_path, deterministic):
    kw = dict(KW, rounds=3, global_batch=8, seq_len=64)
    full, _ = ttrain.train(ckpt_dir=str(tmp_path / "full"), resume=False,
                           device="cpu", **kw)
    fresh = tmp_path / "resumed"
    fresh.mkdir()
    shutil.copy(tmp_path / "full" / "step_2.ckpt", fresh)
    log = str(tmp_path / "ev.jsonl")
    resumed, history = ttrain.train(ckpt_dir=str(fresh), device="cpu",
                                    log_jsonl=log, **kw)
    assert [h["round"] for h in history] == [2]
    assert {"event": "resume", "round": 2}.items() <= _events(log)[1].items()
    a = tree_leaves(full.params) + tree_leaves(full.opt.mu) + tree_leaves(
        full.opt.nu) + [full.opt.step]
    b = tree_leaves(resumed.params) + tree_leaves(resumed.opt.mu) + \
        tree_leaves(resumed.opt.nu) + [resumed.opt.step]
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n_pods,n_dev,federated", [
    (1, 1, False), (2, 1, False), (2, 2, True), (2, 4, True),
    (3, 4, False), (4, 2, False), (1, 4, False), (4, 4, True)])
def test_pods_raise_only_on_the_federated_path(monkeypatch, n_pods, n_dev,
                                               federated):
    monkeypatch.setattr(ttrain, "device_count", lambda dev: n_dev)
    kw = dict(KW, n_pods=n_pods, rounds=0)
    if federated:
        with pytest.raises(NotImplementedError, match="make_fed_train_step"):
            ttrain.train(device="cpu", **kw)
    else:
        _, history = ttrain.train(device="cpu", **kw)
        assert history == []


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(**KW)


def test_fed_update_bits_count_like_the_reference():
    """The port's payload bits equal the reference's accounting on the
    same shapes (the smoke tree against the reference's own)."""
    jcfg = jtrain.get_config("olmo-1b", smoke=True)
    cfg = get_config("olmo-1b", smoke=True)
    for scheme in ("none", "int8"):
        assert (ttrain.stepfns.fed_update_bits(cfg, scheme)
                == jstep.fed_update_bits(jcfg, scheme))


def _reference_bits(cfg, scheme: str) -> int:
    """The reference's ``compressed_update_bits`` over the port's
    parameter shapes, built on the meta device (no storage)."""
    params = lm._init(cfg, None, torch.device("meta"))
    tree = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                       np.float32),
                        params)
    return compressed_update_bits(tree, CompressorConfig(scheme=scheme))


def reference_train_syncs(config_overrides, rounds: int):
    """Each round's sync of ``train()``'s timeline at olmo-1b's full
    width, one pod, the defaults otherwise, on the JAX package."""
    cfg = get_config("olmo-1b").replace(grad_accum=1,
                                        **(config_overrides or {}))
    up = float(_reference_bits(cfg, "int8"))
    down = float(_reference_bits(cfg, "none"))
    rng = np.random.default_rng(0)
    profiles = [JClientProfile(client_id=i, t_ud=float(t), t_dl=0.0,
                               m_ud_bits=up)
                for i, t in enumerate(rng.uniform(1.0, 5.0, 2))]
    spec = JSweepSpec(
        cases=(JSweepCase(workload=JWorkload(clients=profiles,
                                             model_bits=down),
                          load=0.8, policy="bs", seed=0),),
        pon=JPON(n_onus=8), schedule=JSchedule(n_rounds=rounds))
    return tuple(float(s) for s in jsimulate(spec)[0].sync_times), (up,
                                                                   down)


def test_chip_smoke_train_sync_pins():
    cs = _load_chip_smoke()
    for name, (overrides, rounds) in cs.TRAIN_RUNS.items():
        want, (up, down) = reference_train_syncs(overrides, rounds)
        assert cs.TRAIN_SYNC_PINS[name] == want, name
        cfg = get_config("olmo-1b").replace(grad_accum=1,
                                            **(overrides or {}))
        assert float(ttrain.stepfns.fed_update_bits(cfg, "int8")) == up
        assert float(ttrain.stepfns.fed_update_bits(cfg, "none")) == down
        spec, _ = ttrain.net_spec(1, up, down, rounds)
        got = tsimulate(spec, device="cpu")[0].sync_times
        assert tuple(float(s) for s in got) == want, name
