"""The port's federated step functions (``repro_torch.dist.stepfns``)
against the JAX package's, on the CPU.

Inputs: olmo-1b's smoke config with two pods, the reference's
``init_fed_state`` (key 0) carried across by
``from_reference_train_state``, the pods' parameters diverged by seeded
numpy noise of 0.01 (``tests/test_fed_round.py``'s ``fed_state``), each
pod's batches from its own ``TokenBatcher``.

* ``init_fed_state``: one init repeated a pod, each pod's copy in
  storage of its own.
* ``make_fed_train_step`` over 2 steps against the jitted reference
  (``jax.vmap`` of its single-pod step): each pod's loss within
  ``LOSS_TOL``, gradient norm and moments within ``GRAD_RTOL`` of their
  largest magnitude, the lr bit for bit, the parameters within
  ``PARAM_ATOL``; and bit for bit the port's single-pod step run on each
  pod's slice.
* ``make_fed_round_step`` (every scheme, with and without error
  feedback) against the eager reference step within ``PARAM_ATOL``, the
  optimizer state passed through; int8 against the jitted reference
  within one code step an element (caveat C7: XLA multiplies by
  ``f32(1/127)`` where the eager reference divides).
* ``make_async_round_step`` over a 4-event sequence (snap both; a lone
  stale arrival with a partial fraction; a quorum that fails; both
  arrive) against the eager reference, with and without int8 and error
  feedback; the snapshot freezes the in-flight payload.
* ``payload_summary`` equal as a dict; the pod-stacked and async states
  carried across and refused on a key, shape or dtype mismatch; the
  coupled checkpoint tree ``{"train", "async"}`` saved and restored bit
  for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenBatcher as JBatcher
from repro.data import lm_tokens as jtokens
from repro.dist import stepfns as jstep
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import load, save
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.dist import stepfns as tstep
from repro_torch.models.convert import (
    from_reference_async_state,
    from_reference_train_state,
)
from repro_torch.optim import OptimizerConfig, warmup_cosine

N_PODS = 2
LOSS_TOL = 2e-5       # float32 losses of order 5
GRAD_RTOL = 2e-5      # of a leaf's largest magnitude
PARAM_ATOL = 1e-6     # float32 parameters of order 1
LR = 3e-3
SCHEMES = ("none", "int8", "topk", "int8+topk")


def _diverged(state, seed: int = 0, scale: float = 0.01):
    rng = np.random.default_rng(seed)
    return state._replace(params=jax.tree.map(
        lambda l: l + (scale * rng.standard_normal(l.shape)).astype(
            l.dtype), state.params))


@pytest.fixture(scope="module")
def fed_state():
    """(reference config, port config, numpy reference TrainState with
    diverged pods)."""
    jcfg = jget_config("olmo-1b", smoke=True).replace(grad_accum=1)
    state = jstep.init_fed_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.OptimizerConfig(name="adamw", lr=LR),
                                 N_PODS)
    state = _diverged(jax.tree.map(np.asarray, state))
    return jcfg, get_config("olmo-1b", smoke=True).replace(grad_accum=1), \
        state


def _port(state, cfg):
    return from_reference_train_state(state, cfg, device="cpu")


def _close(got, want, what, atol=PARAM_ATOL, rel=False):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(leaves) == len(flat)
    for (p, w), g in zip(flat, leaves):
        w = np.asarray(w)
        tol = atol * max(float(np.abs(w).max()), 1e-30) if rel else atol
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   rtol=0, atol=tol,
                                   err_msg=what + jax.tree_util.keystr(p))


def _leaves(tree) -> list:
    """Every tensor of a tree of dicts and NamedTuples, in order."""
    return [leaf for _, leaf in _flatten_with_paths(tree)]


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _batches(vocab: int, n_steps: int, per_pod: int = 2, seq: int = 16):
    """n_steps stacked batches ``(N_PODS, per_pod, seq)``, each pod's from
    its own ``TokenBatcher``, as ``train()`` builds them."""
    tokens = jtokens(400_000, vocab, seed=0)
    iters = [iter(JBatcher(tokens, per_pod, seq, seed=i, pod_index=i,
                           n_pods=N_PODS)) for i in range(N_PODS)]
    out = []
    for _ in range(n_steps):
        parts = [next(g) for g in iters]
        out.append({k: np.stack([p[k] for p in parts]) for k in parts[0]})
    return out


def test_init_fed_state_replicates_one_init():
    cfg = get_config("olmo-1b", smoke=True)
    opt_cfg = OptimizerConfig(name="adamw", lr=LR)
    gen = torch.Generator().manual_seed(5)
    fed = tstep.init_fed_state(cfg, opt_cfg, N_PODS, gen, device="cpu")
    one = tstep.init_train_state(cfg, opt_cfg,
                                 torch.Generator().manual_seed(5),
                                 device="cpu")
    assert tuple(fed.opt.step.shape) == (N_PODS,)
    for f, o in zip(tree_leaves(fed.params) + tree_leaves(fed.opt.mu),
                    tree_leaves(one.params) + tree_leaves(one.opt.mu)):
        assert tuple(f.shape) == (N_PODS,) + tuple(o.shape)
        assert torch.equal(f[0], o) and torch.equal(f[1], o)
        # materialised: no pod shares another's storage
        assert f.stride(0) == o.numel() and f.is_contiguous()


def test_fed_train_step_matches_reference(fed_state):
    jcfg, cfg, state = fed_state
    jfn = jax.jit(jstep.make_fed_train_step(
        jcfg, jopt.OptimizerConfig(name="adamw", lr=LR),
        jsched.warmup_cosine(LR, 1, 2)))
    tfn = tstep.make_fed_train_step(cfg, OptimizerConfig("adamw", lr=LR),
                                    warmup_cosine(LR, 1, 2))
    js, ts = jax.tree.map(jnp.asarray, state), _port(state, cfg)
    for batch in _batches(jcfg.vocab_size, 2):
        js, jm = jfn(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tfn(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert tuple(tm["loss"].shape) == (N_PODS,)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]),
                                   rtol=GRAD_RTOL)
        assert (tm["lr"].numpy().tobytes()
                == np.asarray(jm["lr"], np.float32).tobytes())
    assert ts.opt.step.tolist() == [2, 2]
    _close(ts.params, js.params, "params")
    _close(ts.opt.mu, js.opt.mu, "mu", GRAD_RTOL, rel=True)
    _close(ts.opt.nu, js.opt.nu, "nu", GRAD_RTOL, rel=True)


def test_fed_train_step_is_the_single_step_on_each_pod(fed_state):
    _, cfg, state = fed_state
    opt_cfg = OptimizerConfig("adamw", lr=LR)
    ts = _port(state, cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg.vocab_size, 1)[0].items()}
    fed, fm = tstep.make_fed_train_step(cfg, opt_cfg)(ts, batch)
    single = tstep.make_train_step(cfg, opt_cfg)
    for i in range(N_PODS):
        pod = tree_map(lambda l: l[i].clone(), ts)
        one, m = single(pod, {k: v[i] for k, v in batch.items()})
        assert _same(tree_map(lambda l: l[i], fed), one)
        assert all(torch.equal(fm[k][i], m[k]) for k in m)
    # the caller's state is untouched
    assert _same(ts, _port(state, cfg))


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fed_round_step_matches_reference(fed_state, scheme, ef):
    jcfg, cfg, state = fed_state
    w = np.array([1.0, 3.0], np.float32)
    ts = _port(state, cfg)
    js = jax.tree.map(jnp.asarray, state)
    jfn = jstep.make_fed_round_step(jcfg, scheme, error_feedback=ef)
    tfn = tstep.make_fed_round_step(cfg, scheme, error_feedback=ef)
    if ef:
        jres = jstep.init_round_residuals(js)
        tres = tstep.init_round_residuals(ts)
        # a second round, so that the residuals carried in are not zero
        js, jres = jfn(js, jnp.asarray(w), jres)
        ts, tres = tfn(ts, torch.from_numpy(w), tres)
        js, jres = jfn(_diverge_j(js), jnp.asarray(w), jres)
        ts, tres = tfn(_diverge_t(ts), torch.from_numpy(w), tres)
        _close(tres, jres, "residuals")
    else:
        js = jfn(js, jnp.asarray(w))
        out = tfn(ts, torch.from_numpy(w))
        assert out.opt is ts.opt      # optimizer moments stay pod-local
        ts = out
    _close(ts.params, js.params, "params")
    for leaf in tree_leaves(ts.params):
        assert torch.equal(leaf[0], leaf[1])


def _noise(shape, seed):
    return (0.01 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _diverge_j(js):
    leaves, treedef = jax.tree.flatten(js.params)
    return js._replace(params=jax.tree.unflatten(treedef, [
        l + _noise(l.shape, 50 + i) for i, l in enumerate(leaves)]))


def _diverge_t(ts):
    from repro_torch._tree import tree_unflatten

    leaves = tree_leaves(ts.params)
    return ts._replace(params=tree_unflatten(ts.params, [
        l + torch.from_numpy(_noise(tuple(l.shape), 50 + i))
        for i, l in enumerate(leaves)]))


@pytest.mark.parametrize("scheme", ["int8", "int8+topk"])
def test_int8_round_against_jitted_reference_within_one_code(fed_state,
                                                             scheme):
    """C7: the jitted reference's int8 FedAvg may move a pod's code by
    one, which moves the average by at most that pod's scale times its
    weight; every element is allowed one full scale."""
    jcfg, cfg, state = fed_state
    w = np.array([1.0, 3.0], np.float32)
    js = jax.jit(jstep.make_fed_round_step(jcfg, scheme))(
        jax.tree.map(jnp.asarray, state), jnp.asarray(w))
    ts = tstep.make_fed_round_step(cfg, scheme)(_port(state, cfg),
                                                torch.from_numpy(w))
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    for (p, want), got, start in zip(flat, tree_leaves(ts.params),
                                     jax.tree.leaves(state.params)):
        delta = torch.from_numpy((start - start[:1]).astype(np.float32))
        if "topk" in scheme:
            delta = torch.stack([tstep.fedops.topk_sparsify(r, 0.05)
                                 for r in delta])
        step = float(delta.abs().max()) / 127.0
        diff = np.abs(got.numpy() - np.asarray(want)).max()
        assert diff <= step * (1 + 1e-6) + PARAM_ATOL, \
            jax.tree_util.keystr(p)


# the 4-event sequence: (arrived, staleness, frac, snap, rejoin, drift)
EVENTS = (
    ([False, False], [0, 0], [1.0, 1.0], [True, True], [False, False],
     0.0),
    ([False, True], [0, 1], [1.0, 0.5], [False, False], [False, True],
     0.02),
    ([True, False], [1, 0], [1.0, 1.0], [False, True], [True, False],
     0.0),
    ([True, True], [0, 1], [1.0, 1.0], [True, False], [True, True], 0.01),
)
ASYNC_CASES = {"none": ("none", False), "int8": ("int8", False),
               "int8_ef": ("int8", True), "topk_ef": ("topk", True)}


@pytest.mark.parametrize("case", list(ASYNC_CASES))
def test_async_round_sequence_matches_reference(fed_state, case):
    scheme, ef = ASYNC_CASES[case]
    jcfg, cfg, state = fed_state
    # a true global: every pod synced to pod 0's rows, then moved apart
    synced = state._replace(params=jax.tree.map(
        lambda l: np.broadcast_to(l[:1], l.shape).copy(), state.params))
    ja = jstep.init_async_state(jax.tree.map(jnp.asarray, synced))
    js = jax.tree.map(jnp.asarray, _diverged(synced, seed=7, scale=0.02))
    ts = _port(jax.tree.map(np.asarray, js), cfg)
    ta = tstep.init_async_state(_port(synced, cfg))
    kw = dict(compress=scheme, error_feedback=ef, server_lr=0.9,
              quorum_frac=0.5, quorum_expected=3)
    jfn = jstep.make_async_round_step(jcfg, **kw)
    tfn = tstep.make_async_round_step(cfg, **kw)
    jres, tres = jstep.init_round_residuals(js), tstep.init_round_residuals(ts)
    w = np.array([1.0, 2.0], np.float32)
    globals_seen = []
    for i, (arr, st, fr, snap, rejoin, drift) in enumerate(EVENTS):
        args = [np.array(arr), np.array(st, np.int32),
                np.array(fr, np.float32), np.array(snap), np.array(rejoin)]
        jargs = [jnp.asarray(w)] + [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(w)] + [torch.from_numpy(a) for a in args]
        if ef:
            js, ja, jres = jfn(js, ja, *jargs, jres)
            ts, ta, tres = tfn(ts, ta, *targs, tres)
            _close(tres, jres, f"event {i} residuals")
        else:
            js, ja = jfn(js, ja, *jargs)
            ts, ta = tfn(ts, ta, *targs)
        for what in ("global_params", "refs", "pending"):
            _close(getattr(ta, what), getattr(ja, what), f"event {i} {what}")
        _close(ts.params, js.params, f"event {i} params")
        globals_seen.append(tree_leaves(ta.global_params)[0].clone())
        if drift:   # local steps after the event move every pod's params
            js = _diverged(jax.tree.map(np.asarray, js), seed=20 + i,
                           scale=drift)
            ts = _port(js, cfg)
            js = jax.tree.map(jnp.asarray, js)
    # event 2 is below quorum (one arrival of 3 expected): global held
    assert torch.equal(globals_seen[2], globals_seen[1])
    assert not torch.equal(globals_seen[3], globals_seen[2])


def test_snapshot_freezes_the_inflight_payload(fed_state):
    """Drift after a snapshot does not leak into the pending upload."""
    _, cfg, state = fed_state
    ts = _port(state, cfg)
    ta = tstep.init_async_state(_port(_diverged(state, seed=9), cfg))
    step = tstep.make_async_round_step(cfg)
    no, yes = torch.zeros(N_PODS, dtype=torch.bool), torch.ones(
        N_PODS, dtype=torch.bool)
    z, ones = torch.zeros(N_PODS, dtype=torch.int32), torch.ones(N_PODS)
    _, a1 = step(ts, ta, ones, no, z, ones, yes, no)
    _, a2 = step(_diverge_t(ts), a1, ones, no, z, ones, no, no)
    assert _same(a2.pending, a1.pending)
    assert not _same(a1.pending, tstep.init_async_state(ts).pending)


def test_payload_summary_equals_reference():
    for scheme_set in (("none", "int8"), ("none", "int8", "topk",
                                          "int8+topk")):
        assert (tstep.payload_summary(get_config("olmo-1b", smoke=True),
                                      scheme_set)
                == jstep.payload_summary(jget_config("olmo-1b", smoke=True),
                                         scheme_set))


def test_stacked_states_carried_across(fed_state):
    jcfg, cfg, state = fed_state
    ts = _port(state, cfg)
    assert tuple(ts.opt.step.shape) == (N_PODS,)
    for g, w in zip(tree_leaves(ts.params) + tree_leaves(ts.opt.nu),
                    jax.tree.leaves(state.params)
                    + jax.tree.leaves(state.opt.nu)):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    ja = jax.tree.map(np.asarray, jstep.init_async_state(
        jax.tree.map(jnp.asarray, state)))
    jres = jax.tree.map(lambda l: _noise(l.shape, 3), state.params)
    ta, tres = from_reference_async_state(ja, cfg, "cpu", residuals=jres)
    for got, want in ((ta.global_params, ja.global_params),
                      (ta.refs, ja.refs), (ta.pending, ja.pending),
                      (tres, jres)):
        assert [g.numpy().tobytes() for g in tree_leaves(got)] == [
            np.asarray(w).tobytes() for w in jax.tree.leaves(want)]
    assert isinstance(from_reference_async_state(ja, cfg, "cpu"),
                      tstep.AsyncRoundState)


def _replace_leaf(tree, key, value):
    out = dict(tree)
    out[key] = value
    return out


@pytest.mark.parametrize("what", ["key", "shape", "dtype"])
def test_stacked_states_refuse_a_mismatch(fed_state, what):
    _, cfg, state = fed_state
    embed = state.params["embed"]
    bad = {"key": ("embedding", embed),
           "shape": ("embed", embed[:1]),
           "dtype": ("embed", embed.astype(np.float64))}[what]
    params = dict(state.params)
    if what == "key":
        del params["embed"]
    params[bad[0]] = bad[1]
    with pytest.raises(ValueError):
        from_reference_train_state(state._replace(params=params), cfg,
                                   device="cpu")
    astate = jax.tree.map(np.asarray, jstep.init_async_state(
        jax.tree.map(jnp.asarray, state)))
    with pytest.raises(ValueError):
        from_reference_async_state(astate._replace(refs=params), cfg, "cpu")
    pending = dict(astate.pending)
    pending["embed"] = np.asarray(astate.pending["embed"], np.float64)
    with pytest.raises(ValueError, match="pending/embed"):
        from_reference_async_state(astate._replace(pending=pending), cfg,
                                   "cpu")


def test_coupled_checkpoint_tree_round_trips(fed_state, tmp_path):
    """``{"train": TrainState, "async": AsyncRoundState}`` (nested
    NamedTuples) through the JSON manifest, bit for bit; the shared
    leaves of a fresh async state come back as separate tensors."""
    _, cfg, state = fed_state
    ts = _port(state, cfg)
    tree = {"train": ts, "async": tstep.init_async_state(ts)}
    path = str(tmp_path / "step_1.ckpt")
    save(path, tree, {"round": 1})
    like = {"train": tree_map(torch.zeros_like, ts),
            "async": tstep.init_async_state(
                tree_map(torch.zeros_like, ts))}
    back, meta = load(path, like=like)
    assert meta["round"] == 1
    assert isinstance(back["train"], tstep.TrainState)
    assert isinstance(back["async"], tstep.AsyncRoundState)
    assert _same(back, tree)
    assert (tree_leaves(back["async"].refs)[0].data_ptr()
            != tree_leaves(back["train"].params)[0].data_ptr())
