"""The port's partition rules (``repro_torch.dist.sharding``) and input
specs (``repro_torch.launch.specs``) against the JAX package's, on the
CPU, on abstract meshes.

* ``param_specs`` and ``opt_moment_specs`` (ZeRO) entry for entry equal
  to the reference's for every leaf of all ten configs at their
  published widths: the reference's shapes from ``jax.eval_shape``, the
  port's from its init on the meta device. Meshes: ``(16, 16)``
  ``("data", "model")``, ``(2, 16, 16)`` and ``(2, 2, 2)`` ``("pod",
  "data", "model")``, each with ``fsdp`` None, True and False (arctic's
  128 experts take the expert-parallel branch, mixtral's 8 the matrix
  rule).
* ``batch_spec`` at batches {1, 2, 8, 32, 256, 512}; ``cache_specs`` of
  every config (the int8 cache, the SSD ``h``, the RG-LRU ``h`` and
  ``conv`` among them).
* ``launch/specs.py``'s state (single-pod and fed), train-batch (the
  pixtral and musicgen frontends, fed ``podify``), prefill and decode
  specs: shape, dtype and spec.
* ``to_placements`` on a one-rank gloo mesh (and the placements a
  DTensor keeps).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import list_architectures
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.dist import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.optim.optimizers import OptimizerConfig as JOptimizerConfig
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import OptimizerConfig

ARCHS = list_architectures()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
BATCHES = (1, 2, 8, 32, 256, 512)


def _jmesh(name):
    shape, axes = MESHES[name]
    return JAbstractMesh(shape, axes)


def _tmesh(name):
    return AbstractMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jget_config(arch)
    return cfg, jax.eval_shape(lambda k: jlm.init_params(k, cfg),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = get_config(arch)
    return cfg, lm.init_params(cfg, device="meta")


def _names(path):
    return [str(getattr(e, "key", getattr(e, "name", e))) for e in path]


def _ref_flat(tree):
    """[(path names, leaf)] of a reference tree, jax's order."""
    return [(_names(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _port_flat(tree[k], prefix + (k,))]
    return [(list(prefix), tree)]


def _spec_flat(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _same_specs(port_tree, ref_tree, what):
    got = [tuple(s) for _, s in _port_flat(port_tree)]
    want = [tuple(s) for s in _spec_flat(ref_tree)]
    assert got == want, what


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def test_production_meshes():
    for multi, name in ((False, "16x16"), (True, "2x16x16")):
        mesh = make_production_mesh(multi_pod=multi)
        shape, axes = MESHES[name]
        assert mesh.axis_names == axes
        assert tuple(mesh.shape.values()) == shape
        assert dict(mesh.shape) == dict(_jmesh(name).shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_equal_the_reference(arch, mesh_name):
    jcfg, jparams = _ref_params(arch)
    cfg, params = _port_params(arch)
    ref = _ref_flat(jparams)
    got = _port_flat(params)
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert [tuple(t.shape) for _, t in got] == [tuple(t.shape)
                                               for _, t in ref]
    jm, tm = _jmesh(mesh_name), _tmesh(mesh_name)
    for fsdp in (None, True, False):
        _same_specs(shd.param_specs(params, cfg, tm, fsdp=fsdp),
                    jshd.param_specs(jparams, jcfg, jm, fsdp=fsdp),
                    f"{arch} {mesh_name} fsdp={fsdp}")
        for zero in (True, False):
            c, jc = (cfg.replace(fsdp=bool(fsdp), zero_opt=zero),
                     jcfg.replace(fsdp=bool(fsdp), zero_opt=zero))
            _same_specs(shd.opt_moment_specs(params, c, tm),
                        jshd.opt_moment_specs(jparams, jc, jm),
                        f"{arch} {mesh_name} moments fsdp={fsdp} "
                        f"zero={zero}")


def test_moe_branches_are_reached():
    """arctic's 128 experts go expert-parallel over 16, mixtral's 8 take
    the generic matrix rule."""
    mesh = _tmesh("16x16")
    for arch, e_model in (("arctic_480b", True), ("mixtral_8x22b", False)):
        cfg, params = _port_params(arch)
        spec = shd.param_specs(params, cfg, mesh)
        s = spec["units"]["b0"]["moe"]["w_gate"]
        assert (s[1] == "model") is e_model, (arch, s)
        assert (s[-1] == "model") is (not e_model), (arch, s)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_equal_the_reference(mesh_name):
    jm, tm = _jmesh(mesh_name), _tmesh(mesh_name)
    for b in BATCHES:
        assert tuple(shd.batch_spec(tm, b)) == tuple(jshd.batch_spec(jm, b))
        assert shd._batch_axes(tm, b) == jshd._batch_axes(jm, b)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    jm, tm = _jmesh(mesh_name), _tmesh(mesh_name)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for batch, max_len in ((32, 4096), (2, 512)):
        jshapes = jax.eval_shape(
            functools.partial(jlm.init_cache, jcfg, batch, max_len))
        shapes = lm.init_cache(cfg, batch, max_len, device="meta")
        got = shd.cache_specs(shapes, cfg, tm, batch)
        want = jshd.cache_specs(jshapes, jcfg, jm, batch)
        _same_specs(got, want, f"{arch} {mesh_name} B={batch}")
        names = [n[-1] for n, _ in _port_flat(got)]
        if arch == "arctic-480b":
            assert "k_scale" in names
        if arch == "mamba2-780m":
            assert "h" in names
        if arch == "recurrentgemma-2b":
            assert {"h", "conv"} <= set(names)


def _same_tensor_specs(got, want, what):
    """Port TensorSpecs against reference ShapeDtypeStructs, leaf for
    leaf: shape, dtype and spec."""
    g = [t for _, t in _port_flat(got)] if isinstance(got, dict) else got
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), what
        assert _dtype_name(a.dtype) == _dtype_name(b.dtype), what
        assert tuple(a.spec) == tuple(b.sharding.spec), (what, a, b)


def _state_leaves(state):
    return (tree_leaves(state.params) + [state.opt.step]
            + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_specs_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jopt, opt = JOptimizerConfig(), OptimizerConfig()
    for mesh_name in ("16x16", "2x16x16"):
        jm, tm = _jmesh(mesh_name), _tmesh(mesh_name)
        pod = "pod" in MESHES[mesh_name][1]
        # the single-pod state on the pod-less mesh, the fed state on the
        # pod mesh
        for fed in (pod,):
            want, _ = jspecs.state_specs(jcfg, jopt, jm, fed=fed, n_pods=2)
            got, spec_tree = specs.state_specs(cfg, opt, tm, fed=fed,
                                               n_pods=2)
            w = (jax.tree_util.tree_leaves(want.params) + [want.opt.step]
                 + jax.tree_util.tree_leaves(want.opt.mu)
                 + jax.tree_util.tree_leaves(want.opt.nu))
            _same_tensor_specs(_state_leaves(got), w,
                               f"{arch} {mesh_name} state fed={fed}")
            assert [tuple(s) for s in _state_leaves(spec_tree)] == [
                tuple(t.spec) for t in _state_leaves(got)]
        for jshape, shape in zip(J_SHAPES, ALL_SHAPES):
            assert jshape.name == shape.name
            for fed in ((False, True) if pod else (False,)):
                if fed and shape.global_batch % 2:
                    continue
                _same_tensor_specs(
                    specs.train_batch_specs(cfg, shape, tm, fed=fed,
                                            n_pods=2),
                    jspecs.train_batch_specs(jcfg, jshape, jm, fed=fed,
                                             n_pods=2),
                    f"{arch} {mesh_name} {shape.name} batch fed={fed}")
        for jshape, shape in zip(J_SHAPES[1:3], ALL_SHAPES[1:3]):
            t_tok, t_cache, _, t_extra = specs.prefill_input_specs(
                cfg, shape, tm)
            j_tok, j_cache, _, j_extra = jspecs.prefill_input_specs(
                jcfg, jshape, jm)
            _same_tensor_specs([t_tok], [j_tok], f"{arch} prefill tokens")
            _same_tensor_specs(t_cache, j_cache, f"{arch} prefill cache")
            assert (t_extra is None) == (j_extra is None)
            if t_extra is not None:
                _same_tensor_specs([t_extra], [j_extra], f"{arch} extra")
            t_tok, t_cache, _ = specs.decode_input_specs(cfg, shape, tm)
            j_tok, j_cache, _ = jspecs.decode_input_specs(jcfg, jshape, jm)
            _same_tensor_specs([t_tok], [j_tok], f"{arch} decode token")
            _same_tensor_specs(t_cache, j_cache, f"{arch} decode cache")
    if cfg.frontend:
        batch = specs.train_batch_specs(cfg, ALL_SHAPES[0],
                                        _tmesh("2x16x16"), fed=True,
                                        n_pods=2)
        assert "extra_embeds" in batch


def test_meta_init_draws_nothing_and_keeps_the_draws():
    """The meta path allocates no storage, and a real init draws what it
    drew before the meta path existed (the same generator stream)."""
    cfg = get_config("olmo-1b", smoke=True)
    meta = lm.init_params(cfg, device="meta")
    assert all(t.is_meta for t in tree_leaves(meta))
    a = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = lm._init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert [tuple(t.shape) for t in tree_leaves(meta)] == [
        tuple(t.shape) for t in tree_leaves(a)]


@pytest.fixture
def gloo_group():
    """A one-rank gloo process group on an in-process store."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


@pytest.fixture
def one_rank_mesh(gloo_group):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))


def test_host_mesh_is_on_the_callers_device(gloo_group):
    """``make_host_mesh`` builds its mesh on the device type it is
    given, and raises where the running group's backend cannot serve it
    (a gloo group meeting the card), whether or not a card is there;
    ``tests/test_torch_cuda.py`` runs ``train()`` on the card under such
    a group."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, device="cpu")
    assert mesh.device_type == "cpu"
    assert mesh.mesh_dim_names == ("data", "model")
    assert make_host_mesh(1, pods=1, pod_axis=True, device="cpu"
                          ).mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="cuda mesh needs a nccl"):
        make_host_mesh(1, device="cuda")


def test_to_placements_on_a_one_rank_mesh(one_rank_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = one_rank_mesh
    P = shd.P
    cases = {
        P(("pod", "data"), None): (Shard(0), Shard(0), Replicate()),
        P("pod", "data", "model"): (Shard(0), Shard(1), Shard(2)),
        P(None, "model"): (Replicate(), Replicate(), Shard(1)),
        P("model", None): (Replicate(), Replicate(), Shard(0)),
        P(None): (Replicate(),) * 3,
        P(): (Replicate(),) * 3,
        P("pod", None, ("data", "model")): (Shard(0), Shard(2), Shard(2)),
    }
    for spec, want in cases.items():
        got = shd.to_placements(spec, mesh)
        assert got == want, spec
        x = torch.arange(24.0).reshape(2, 3, 4)
        d = distribute_tensor(x, mesh, got)
        # kept as plain shards (no _StridedShard), the whole tensor back
        assert tuple(d.placements) == want
        assert all(type(p) in (Shard, Replicate) for p in d.placements)
        assert torch.equal(d.full_tensor(), x)
    with pytest.raises(ValueError):
        shd.to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        shd.to_placements(P("model", "model"), mesh)
    # the production spec tree of a fed state turns into placements
    cfg = get_config("olmo-1b", smoke=True)
    state_specs = specs.state_spec_tree(
        specs.state_shapes(cfg, OptimizerConfig(), 2), cfg, mesh, fed=True)
    pl = shd.spec_tree_placements(state_specs.params, mesh)
    assert all(p[0] == Shard(0) for p in tree_leaves(pl))

