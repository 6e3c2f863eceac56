"""The port's training on a ``torch.distributed`` ``DeviceMesh``, on the
CPU: four gloo ranks from one ``torch.multiprocessing.spawn`` over a
``FileStore`` (module scope), every check of the file run in that one
spawn, against one process.

Inputs: olmo-1b's smoke config (its own ``attn_impl="chunked"``, so that
the attention's local-part boundary runs), two pods, the reference's
``init_fed_state`` (key 0) carried across with the pods diverged, each
pod's batches from its own ``TokenBatcher``, AdamW under a warmup-cosine
schedule: ``tests/test_torch_fed_steps.py``'s setup.

* Two fed steps (``make_fed_train_step`` with the per-pod
  ``grad_shardings`` and ``spmd_axis_name="pod"``) on meshes ``(2, 1, 1)``
  (ranks 0 and 1), ``(2, 2, 1)`` and ``(2, 1, 2)`` ``("pod", "data",
  "model")``: the ``full_tensor()`` of every leaf of the state, and the
  metrics, bit for bit the one-process stacked run on ``(2, 1, 1)`` (a
  two-term sum does not depend on its order), within rtol 1e-5, atol
  1e-6 on the others (the data mean and the row-parallel partial sums
  reassociate float32 sums); and within ``tests/test_torch_fed_steps.py``'s
  tolerances of the reference's jitted ``vmap`` step. The state comes
  back in its placements.
* An int8 FedAvg round, with and without error feedback, and two FedBuff
  rounds through the quorum gate (met, then failed), on every mesh from
  the one-process stepped state placed there: bit for bit the one
  process (the plain quantiser sees each pod's whole leaf).
* ``shard_batch``: each rank holds the rows its mesh coordinate gives,
  as plain ``Shard`` placements (no ``_StridedShard``).
* The kernels' boundary (``_dtensor.local_kernel``): K4's, K5's and
  K6's dispatch on DTensors split over the batch (``data``) and the
  heads or channels (``model``), forward and backward, against the plain
  call on whole tensors.
* ``train(n_pods=2)`` across the four ranks (pod 2 x data 2): every
  round's ``sync_s`` exactly, and the losses within rtol 1e-6, of one
  process with the ``device_count`` seam at 2.
"""
import os

import numpy as np
import pytest
import torch

N_PODS = 2
LR = 3e-3
WORLD = 4
MESHES = {"2x1x1": (2, 1, 1), "2x2x1": (2, 2, 1), "2x1x2": (2, 1, 2)}
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6
LOSS_TOL = 2e-5       # tests/test_torch_fed_steps.py's
GRAD_RTOL = 2e-5
PARAM_ATOL = 1e-6
TRAIN_KW = dict(arch="olmo-1b", steps_per_round=2, rounds=2, n_pods=2,
                global_batch=4, seq_len=16, log_every=100)


def _cfg():
    from repro_torch.configs import get_config

    return get_config("olmo-1b", smoke=True).replace(grad_accum=1,
                                                     attn_impl="chunked")


def _opt():
    from repro_torch.optim import OptimizerConfig

    return OptimizerConfig("adamw", lr=LR)


def _schedule():
    from repro_torch.optim import warmup_cosine

    return warmup_cosine(LR, 1, 2)


def _async_args():
    """Two FedBuff events: one arrival with a partial fraction under a
    0.5 quorum (met), then one stale arrival under a 1.0 quorum (not)."""
    b = lambda v: torch.tensor(v, dtype=torch.bool)  # noqa: E731
    return [
        (0.5, (torch.tensor([1.0, 3.0]), b([True, False]),
               torch.tensor([0, 1], dtype=torch.int32),
               torch.tensor([0.5, 1.0]), b([True, True]), b([True, False]))),
        (1.0, (torch.tensor([1.0, 3.0]), b([False, True]),
               torch.tensor([0, 1], dtype=torch.int32),
               torch.tensor([1.0, 1.0]), b([False, False]),
               b([False, True]))),
    ]


def run_rounds(state):
    """The int8 rounds of the file on ``state`` (plain or placed):
    ``{name: tree}``."""
    from repro_torch.dist import stepfns

    cfg = _cfg()
    w = torch.tensor([1.0, 3.0])
    out = {"fedavg": stepfns.make_fed_round_step(cfg, "int8")(state, w)}
    res = stepfns.init_round_residuals(state)
    out["fedavg_ef"] = stepfns.make_fed_round_step(
        cfg, "int8", error_feedback=True)(state, w, res)
    astate = stepfns.init_async_state(state)
    s = state
    for k, (quorum, args) in enumerate(_async_args()):
        s, astate = stepfns.make_async_round_step(
            cfg, "int8", quorum_frac=quorum,
            quorum_expected=N_PODS)(s, astate, *args)
        out[f"fedbuff{k}"] = (s, astate)
    return out


def _full_tree(tree):
    from repro_torch import _dtensor
    from repro_torch._tree import tree_map

    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_full_tree(t) for t in tree)
    return tree_map(_dtensor.full, tree)


def _place_state(state, mesh):
    from repro_torch.launch import specs

    spec = specs.state_spec_tree(state, _cfg(), mesh, fed=True)
    return specs.place_tree(state, spec, mesh), spec


def _mesh_checks(rank, name, mesh, inputs, out):
    """Every check of one mesh on this rank; rank 0 of the mesh records
    the whole results."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import stepfns

    cfg, opt = _cfg(), _opt()
    state, spec = _place_state(inputs["state"], mesh)
    sub = mesh["data", "model"]
    grad_sh = tree_map(lambda s: shd.to_placements(shd.P(*s[1:]), sub),
                       spec.params)
    step = stepfns.make_fed_train_step(cfg, opt, _schedule(),
                                       grad_shardings=grad_sh,
                                       spmd_axis_name="pod")
    per_pod = inputs["batches"][0]["tokens"].shape[1]
    bspec = shd.P("pod", "data" if per_pod % sub["data"].size() == 0
                  else None, None)
    metrics = []
    for host in inputs["batches"]:
        batch = shard_batch(host, mesh, bspec)
        # each rank holds its coordinate's rows, as plain shards
        coord = mesh.get_coordinate()
        for k, v in batch.items():
            assert all(type(p).__name__ in ("Shard", "Replicate")
                       for p in v.placements), v.placements
            n_data = mesh["data"].size() if bspec[1] else 1
            rows = per_pod // n_data
            d0 = coord[1] * rows if bspec[1] else 0
            want = torch.as_tensor(host[k])[coord[0]:coord[0] + 1,
                                            d0:d0 + rows]
            assert torch.equal(v.to_local(), want), (name, k)
        state, m = step(state, batch)
        metrics.append(_full_tree(m))
    placed = all(
        tuple(a.placements) == tuple(shd.to_placements(s, mesh))
        for a, s in zip(_dtensor_leaves(state), _dtensor_leaves(spec)))
    stepped = _full_tree(state)
    # the rounds from the one-process stepped state, placed here; their
    # states keep the placements
    ref_state, _ = _place_state(inputs["stepped"], mesh)
    placed_rounds = run_rounds(ref_state)
    want_pl = [tuple(a.placements) for a in _dtensor_leaves(ref_state)]
    for name_, tree in placed_rounds.items():
        st = tree if hasattr(tree, "_fields") else tree[0]
        placed = placed and want_pl == [tuple(a.placements)
                                        for a in _dtensor_leaves(st)]
        if name_.startswith("fedbuff"):
            for part in tree[1]:
                placed = placed and [tuple(a.placements)
                                     for a in tree_leaves(part)] == \
                    want_pl[:len(tree_leaves(part))]
    rounds = {k: _full_tree(v) for k, v in placed_rounds.items()}
    kernels = _kernel_checks(mesh)
    if rank == int(mesh.mesh.flatten()[0]):
        out[name] = {"state": stepped, "metrics": metrics,
                     "placed": placed, "rounds": rounds,
                     "kernels": kernels}


def kernel_cases():
    """The kernels' dispatch, seeded inputs and each input's placements
    on a ``("data", "model")`` mesh: name -> (fn, inputs, placements)."""
    from torch.distributed.tensor import Replicate as R
    from torch.distributed.tensor import Shard as S

    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.ssd.ops import ssd_scan

    rng = np.random.default_rng(3)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    B, T, H, K, D, P, N, Rw = 2, 8, 4, 2, 16, 8, 4, 8
    return {
        "k4": (lambda q, k, v: flash_attention(q, k, v, True, None),
               (f(B, T, H, D), f(B, T, K, D), f(B, T, K, D)),
               ((S(0), S(2)),) * 3),
        "k5": (lambda *t: ssd_scan(*t[:5], 4, t[5]),
               (f(B, T, H, P), f(B, T, N), f(B, T, N),
                torch.nn.functional.softplus(f(B, T, H)), -torch.exp(f(H)),
                f(B, H, P, N)),
               ((S(0), S(2)), (S(0), R()), (S(0), R()), (S(0), S(2)),
                (R(), S(0)), (S(0), S(1)))),
        "k6": (rglru_scan,
               (torch.sigmoid(f(B, T, Rw)), f(B, T, Rw), f(B, Rw)),
               ((S(0), S(2)), (S(0), S(2)), (S(0), S(1)))),
    }


def kernel_results(fn, inputs):
    """The outputs of ``fn`` and the gradients of their sum for every
    input, as whole tensors."""
    from repro_torch import _dtensor

    ins = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(sum(o.sum() for o in outs), ins)
    return [_dtensor.full(t).detach() for t in outs + tuple(grads)]


def _kernel_checks(mesh):
    from repro_torch import _dtensor

    sub = mesh["data", "model"]
    out = {}
    for name, (fn, inputs, placements) in kernel_cases().items():
        placed = [_dtensor.place(t, sub, pl)
                  for t, pl in zip(inputs, placements)]
        out[name] = kernel_results(fn, placed)
    return out


def _dtensor_leaves(state):
    from repro_torch._tree import tree_leaves

    return (tree_leaves(state.params) + [state.opt.step]
            + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu))


def _worker(rank, store_path, in_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    inputs = torch.load(in_path, weights_only=False)
    out = {}
    names = ("pod", "data", "model")
    for name, shape in MESHES.items():
        n = int(np.prod(shape))
        if n == WORLD:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        else:
            # built on every rank, over the first n of them
            mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                              mesh_dim_names=names)
        if rank < n:
            _mesh_checks(rank, name, mesh, inputs, out)
        dist.barrier()
    from repro_torch.launch import train as ttrain

    _, history = ttrain.train(device="cpu", **TRAIN_KW)
    out["train"] = history
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _reference_inputs():
    """The reference's fed state (pods diverged) carried across and the
    stacked batches, as ``tests/test_torch_fed_steps.py`` makes them."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.data import TokenBatcher as JBatcher
    from repro.data import lm_tokens as jtokens
    from repro.dist import stepfns as jstep
    from repro.optim import optimizers as jopt
    from repro_torch.models.convert import from_reference_train_state

    jcfg = jget_config("olmo-1b", smoke=True).replace(grad_accum=1)
    state = jstep.init_fed_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.OptimizerConfig(name="adamw", lr=LR),
                                 N_PODS)
    rng = np.random.default_rng(0)
    state = jax.tree.map(np.asarray, state)
    state = state._replace(params=jax.tree.map(
        lambda l: l + (0.01 * rng.standard_normal(l.shape)).astype(l.dtype),
        state.params))
    tokens = jtokens(400_000, jcfg.vocab_size, seed=0)
    iters = [iter(JBatcher(tokens, 2, 16, seed=i, pod_index=i,
                           n_pods=N_PODS)) for i in range(N_PODS)]
    batches = []
    for _ in range(2):
        parts = [next(g) for g in iters]
        batches.append({k: np.stack([p[k] for p in parts])
                        for k in parts[0]})
    port = from_reference_train_state(state, _cfg(), device="cpu")
    return jcfg, state, port, batches


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of the four ranks; returns (rank 0's results, the inputs,
    the reference's state and config)."""
    import torch.multiprocessing as mp

    from repro_torch.dist import stepfns

    tmp = tmp_path_factory.mktemp("mesh")
    jcfg, jstate, state, batches = _reference_inputs()
    step = stepfns.make_fed_train_step(_cfg(), _opt(), _schedule())
    stepped, metrics = state, []
    # the embedding's backward on the CPU adds in a thread-dependent
    # order unless deterministic algorithms are on (the ranks too)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for b in batches:
            stepped, m = step(stepped, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            metrics.append(m)
    finally:
        torch.use_deterministic_algorithms(was)
    in_path = str(tmp / "inputs.pt")
    torch.save({"state": state, "batches": batches, "stepped": stepped},
               in_path)
    mp.spawn(_worker, args=(str(tmp / "store"), in_path, str(tmp)),
             nprocs=WORLD, join=True)
    results = torch.load(str(tmp / "rank0.pt"), weights_only=False)
    return {"results": results, "state": state, "batches": batches,
            "stepped": stepped, "metrics": metrics, "jcfg": jcfg,
            "jstate": jstate}


def _leaves(tree):
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    return _flatten_with_paths(tree)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fed_steps_on_the_mesh_equal_one_process(spawned, mesh):
    got = spawned["results"][mesh]
    assert got["placed"], "a stepped or rounded state left its placements"
    pairs = list(zip(_leaves(got["state"]), _leaves(spawned["stepped"])))
    pairs += [((f"metrics{i}/{k}", gm[k]), (k, wm[k]))
              for i, (gm, wm) in enumerate(zip(got["metrics"],
                                               spawned["metrics"]))
              for k in wm]
    assert len(pairs) > 20
    for (path, a), (_, b) in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if mesh == "2x1x1":
            assert torch.equal(_bits(a), _bits(b)), path
        else:
            torch.testing.assert_close(a, b, rtol=MESH_RTOL,
                                       atol=MESH_ATOL, msg=path)


@pytest.fixture(scope="module")
def reference_steps(spawned):
    """The jitted reference ``vmap`` step over the two batches: each
    step's metrics and the final state, as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.dist import stepfns as jstep
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched

    jfn = jax.jit(jstep.make_fed_train_step(
        spawned["jcfg"], jopt.OptimizerConfig(name="adamw", lr=LR),
        jsched.warmup_cosine(LR, 1, 2)))
    js = jax.tree.map(jnp.asarray, spawned["jstate"])
    metrics = []
    for b in spawned["batches"]:
        js, jm = jfn(js, jax.tree.map(jnp.asarray, b))
        metrics.append({k: np.asarray(v) for k, v in jm.items()})
    return metrics, jax.tree.map(np.asarray, js)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fed_steps_on_the_mesh_match_the_reference(spawned, reference_steps,
                                                   mesh):
    """Within ``tests/test_torch_fed_steps.py``'s tolerances of the
    jitted ``vmap`` reference step."""
    import jax

    from repro_torch._tree import tree_leaves

    jms, js = reference_steps
    got = spawned["results"][mesh]
    for tm, jm in zip(got["metrics"], jms):
        np.testing.assert_allclose(tm["loss"].numpy(), jm["loss"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(tm["grad_norm"].numpy(), jm["grad_norm"],
                                   rtol=GRAD_RTOL)
    for what, tol, rel in (("params", PARAM_ATOL, False),
                           ("mu", GRAD_RTOL, True), ("nu", GRAD_RTOL, True)):
        port = (got["state"].params if what == "params"
                else getattr(got["state"].opt, what))
        ref = js.params if what == "params" else getattr(js.opt, what)
        for g, w in zip(tree_leaves(port), jax.tree.leaves(ref)):
            t = tol * max(float(np.abs(w).max()), 1e-30) if rel else tol
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=t, err_msg=what)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_rounds_on_the_mesh_equal_one_process(spawned, mesh):
    want = run_rounds(spawned["stepped"])
    got = spawned["results"][mesh]["rounds"]
    assert set(got) == set(want)
    for name in want:
        a, b = _leaves(got[name]), _leaves(want[name])
        assert [p for p, _ in a] == [p for p, _ in b], name
        for (path, x), (_, y) in zip(a, b):
            assert torch.equal(_bits(x), _bits(y)), (name, path)
    # the gate: the second event's lone arrival under a 1.0 quorum leaves
    # the global as the first event made it
    g0 = want["fedbuff0"][1].global_params
    g1 = want["fedbuff1"][1].global_params
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(g0), _leaves(g1)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_kernel_boundary_on_the_mesh_equals_the_plain_call(spawned, mesh):
    """Each rank's local part through the dispatch equals the plain call
    on whole tensors: outputs bit for bit (the batch, heads and channels
    are independent), input gradients within float32's default
    tolerance (a gradient summed over split batch rows, K5's ``a``)."""
    got = spawned["results"][mesh]["kernels"]
    for name, (fn, inputs, _) in kernel_cases().items():
        want = kernel_results(fn, inputs)
        n_out = len(want) - len(inputs)
        assert len(got[name]) == len(want), name
        for i, (a, b) in enumerate(zip(got[name], want)):
            if i < n_out:
                assert torch.equal(a, b), (name, i)
            else:
                torch.testing.assert_close(a, b, msg=f"{name} grad {i}")


def test_train_across_ranks_matches_one_process(spawned, monkeypatch):
    from repro_torch.launch import train as ttrain

    monkeypatch.setattr(ttrain, "device_count", lambda dev: 2)
    _, want = ttrain.train(device="cpu", **TRAIN_KW)
    got = spawned["results"]["train"]
    assert [h["round"] for h in got] == [h["round"] for h in want]
    assert [h["sync_s"] for h in got] == [h["sync_s"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-6)
