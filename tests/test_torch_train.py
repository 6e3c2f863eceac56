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
* The federated branch runs exactly where the reference's pod formula
  (``src/repro/launch/train.py:103``) takes it, reached through the
  ``device_count`` seam (the port's counterpart of
  ``XLA_FLAGS=--xla_force_host_platform_device_count``), and returns a
  pod-stacked state; one pod elsewhere.
* ``train(n_pods=2)`` against the reference's in a subprocess that sees
  two host devices, plain int8 rounds and coupled (deadline, faults,
  quorum) rounds, from the reference's ``init_fed_state`` carried
  across: every ``sync_s`` bit for bit, losses within ``LOSS_RTOL``, the
  same events and mesh shape, the parameters within ``PARAM_ATOL`` plus
  one int8 code step a round (the jitted reference's ``amax · f32(1/127)``
  can move a code by one, caveat C7; each round's step is the port's own
  largest scale of that leaf, recorded as it quantises).
* A resumed coupled run (round 2's checkpoint only) equals the
  uninterrupted one bit for bit: its final state and its last
  checkpoint, the async state included.
* ``chip_smoke.TRAIN_SYNC_PINS`` and ``FED_SYNC_PINS`` recomputed with
  the JAX package's engine (the payload bits of the full-width trees,
  counted by the reference's ``compressed_update_bits`` on the port's
  shapes), and the port's own timeline on the CPU at those pins, bit
  for bit.
"""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core.slicing import ClientProfile as JClientProfile
from repro.dist import stepfns as jstep
from repro.faults import FaultSchedule as JFaults
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
from repro_torch.checkpoint import load
from repro_torch.configs import get_config
from repro_torch.dist import fedops as tfed
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
def test_pods_raise_only_on_the_federated_path(monkeypatch, tmp_path,
                                               n_pods, n_dev, federated):
    """The federated branch where the reference's formula gives more
    than one pod (a pod-stacked state, the mesh event's ``pod`` axis),
    the single-pod step elsewhere; neither raises any more."""
    monkeypatch.setattr(ttrain, "device_count", lambda dev: n_dev)
    kw = dict(KW, n_pods=n_pods, rounds=0)
    path = str(tmp_path / "ev.jsonl")
    state, history = ttrain.train(device="cpu", log_jsonl=path, **kw)
    assert history == []
    pods = n_pods if federated else 1
    want = {"data": n_dev // pods, "model": 1}
    if federated:
        want = {"pod": pods, **want}
    assert _events(path)[0]["shape"] == want
    lead = (pods,) if federated else ()
    assert tuple(state.opt.step.shape) == lead
    embed = get_config("olmo-1b", smoke=True)
    assert tuple(state.params["embed"].shape) == lead + (
        embed.vocab_size, embed.d_model)


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


# train(n_pods=2) on both packages: plain int8 FedAvg rounds, and the
# coupled FedBuff rounds under tests/test_faults.py's resume shape
FED_KW = {**{k: v for k, v in KW.items() if k != "rounds"}, "n_pods": 2}
FED_RUNS = {
    "int8": dict(rounds=2),
    "coupled": dict(rounds=3, deadline_s=2.0, deadline_policy="defer",
                    dropout_rate=0.4, loss_rate=0.2, outage_rate=0.5,
                    fault_seed=3, quorum=0.5),
}

_FED_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np
    from repro.launch.train import train

    out, runs, kw = sys.argv[1], json.loads(sys.argv[2]), json.loads(
        sys.argv[3])
    for name, extra in runs.items():
        state, history = train(
            log_jsonl=os.path.join(out, name + ".jsonl"), **kw, **extra)
        flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
        np.savez(os.path.join(out, name + ".npz"),
                 **{jax.tree_util.keystr(p): np.asarray(l)
                    for p, l in flat})
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(history, f)
""")


@pytest.fixture(scope="module")
def fed_reference(tmp_path_factory):
    """The reference's ``train(n_pods=2)`` for each of ``FED_RUNS``, in a
    process that sees two host devices: {name: (params by key path,
    history, events)}."""
    out = tmp_path_factory.mktemp("fed_ref")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(ROOT / "src"), env.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _FED_REFERENCE, str(out),
         json.dumps(FED_RUNS), json.dumps(FED_KW)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = {}
    for name in FED_RUNS:
        with np.load(out / f"{name}.npz") as z:
            params = {k: z[k] for k in z.files}
        with open(out / f"{name}.json") as f:
            history = json.load(f)
        runs[name] = (params, history, _events(out / f"{name}.jsonl"))
    return runs


def _reference_fed_state(cfg):
    jcfg = jtrain.get_config("olmo-1b", smoke=True).replace(grad_accum=1)
    state = jstep.init_fed_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.OptimizerConfig(name="adamw", lr=3e-3),
                                 2)
    return from_reference_train_state(jax.tree.map(np.asarray, state), cfg,
                                      device="cpu")


@pytest.mark.parametrize("name", list(FED_RUNS))
def test_fed_train_equals_reference(fed_reference, name, tmp_path,
                                    monkeypatch):
    want_params, want_hist, want_events = fed_reference[name]
    monkeypatch.setattr(ttrain, "device_count", lambda dev: 2)
    monkeypatch.setattr(ttrain.stepfns, "init_fed_state",
                        lambda cfg, opt_cfg, n, device=None:
                        _reference_fed_state(cfg))
    # each int8 round's scales, in the order the leaves are quantised
    scales = []
    quantize = tfed.quant_ops.quantize_int8

    def recording(x, block):
        q, s = quantize(x, block)
        scales.append(float(s.max()))
        return q, s

    monkeypatch.setattr(tfed.quant_ops, "quantize_int8", recording)
    path = str(tmp_path / "ev.jsonl")
    state, history = ttrain.train(log_jsonl=path, device="cpu", **FED_KW,
                                  **FED_RUNS[name])
    assert [h["round"] for h in history] == [h["round"] for h in want_hist]
    for got, want in zip(history, want_hist):
        assert got["sync_s"] == want["sync_s"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
    leaves = tree_leaves(state.params)
    assert len(leaves) == len(want_params)
    assert len(scales) == len(leaves) * len(history)
    steps = np.asarray(scales).reshape(len(history), len(leaves)).sum(0)
    for (key, w), g, step in zip(want_params.items(), leaves, steps):
        assert g.shape[0] == 2
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=PARAM_ATOL + step, err_msg=key)
    got_events = _events(path)
    assert [_shape(e) for e in got_events] == [_shape(e)
                                               for e in want_events]
    assert got_events[0]["shape"] == want_events[0]["shape"] == {
        "pod": 2, "data": 1, "model": 1}


def test_fed_resume_reproduces_the_uninterrupted_run(tmp_path, monkeypatch,
                                                     deterministic):
    monkeypatch.setattr(ttrain, "device_count", lambda dev: 2)
    kw = dict(FED_KW, **FED_RUNS["coupled"])
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
    a = (tree_leaves(full.params) + tree_leaves(full.opt.mu)
         + tree_leaves(full.opt.nu) + [full.opt.step])
    b = (tree_leaves(resumed.params) + tree_leaves(resumed.opt.mu)
         + tree_leaves(resumed.opt.nu) + [resumed.opt.step])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    # the last checkpoints, the async state included, bit for bit
    ta, _ = load(str(tmp_path / "full" / "step_3.ckpt"))
    tb, _ = load(str(fresh / "step_3.ckpt"))
    assert sorted(ta) == sorted(tb) and any(k.startswith("async/")
                                            for k in ta)
    assert all(torch.equal(ta[k], tb[k]) for k in ta)


def reference_fed_syncs(overrides, rounds: int, **kw):
    """Each round's sync of ``train()``'s timeline at olmo-1b's full
    width with two pods and ``kw`` (deadline, faults, quorum), on the
    JAX package."""
    cfg = get_config("olmo-1b").replace(grad_accum=1, **(overrides or {}))
    up = float(_reference_bits(cfg, "int8"))
    down = float(_reference_bits(cfg, "none"))
    rng = np.random.default_rng(0)
    profiles = [JClientProfile(client_id=i, t_ud=float(t), t_dl=0.0,
                               m_ud_bits=up)
                for i, t in enumerate(rng.uniform(1.0, 5.0, 2))]
    faults = None
    if kw.get("dropout_rate") or kw.get("outage_rate") or kw.get(
            "loss_rate"):
        faults = JFaults(seed=kw.get("fault_seed", 0),
                         dropout_rate=kw.get("dropout_rate", 0.0),
                         outage_rate=kw.get("outage_rate", 0.0),
                         loss_rate=kw.get("loss_rate", 0.0))
    spec = JSweepSpec(
        cases=(JSweepCase(workload=JWorkload(clients=profiles,
                                             model_bits=down),
                          load=0.8, policy="bs", seed=0),),
        pon=JPON(n_onus=8),
        schedule=JSchedule(n_rounds=rounds, deadline_s=kw.get("deadline_s"),
                           deadline_policy=kw.get("deadline_policy",
                                                  "defer"),
                           faults=faults, quorum_frac=kw.get("quorum")))
    return tuple(float(s) for s in jsimulate(spec)[0].sync_times), (up,
                                                                   down)


def test_chip_smoke_fed_sync_pins():
    cs = _load_chip_smoke()
    for name, (overrides, rounds, kw) in cs.FED_RUNS.items():
        want, (up, down) = reference_fed_syncs(overrides, rounds, **kw)
        assert cs.FED_SYNC_PINS[name] == want, name
        spec, _ = ttrain.net_spec(2, up, down, rounds, **kw)
        got = tsimulate(spec, device="cpu")[0].sync_times
        assert tuple(float(s) for s in got) == want, name
