"""The port's cross-pod federated operations (``repro_torch.dist.fedops``)
against the JAX package's ``repro.dist.fedops``, on the CPU.

Inputs: olmo-1b's smoke parameter tree (the reference's ``init_params``,
key 0) under a leading axis of two pods, the pods diverged by seeded
numpy noise of 0.01 as ``tests/test_fed_round.py``'s ``fed_state`` does,
the same numpy arrays fed to both packages.

* Every function for each scheme ``none``/``int8``/``topk``/``int8+topk``,
  with and without error-feedback residuals, against the eager JAX
  functions (no ``jit``): int8 codes and scales exactly (the stacked
  quantiser, one block a pod, against ``jax.vmap(quantize_int8)``), the
  float results within ``PARAM_ATOL``.
* Against jitted JAX the int8 round trip may move a code by one: XLA
  rewrites ``amax / 127`` as a product with ``f32(1/127)`` (caveat C7),
  so there each element is allowed one code step, its pod's scale.
* FedBuff: the quorum gate met and not met, a lone stale arrival, a
  partial fraction, no arrivals, error feedback masked to the arrived
  pods; the staleness discount.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist import fedops as jfed
from repro.fl import compression as jcomp
from repro.models import lm as jlm
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.dist import fedops as tfed
from repro_torch.kernels.quant import ref as qref
from repro_torch.models.convert import _want

N_PODS = 2
PARAM_ATOL = 1e-6     # float32 values of order 1
SCHEMES = ("none", "int8", "topk", "int8+topk")
TOPK_FRAC = 0.05


@pytest.fixture(scope="module")
def pods():
    """(numpy tree of pod-stacked diverged params, numpy tree of
    float32 residuals): every leaf ``(2, ...)``."""
    jcfg = jget_config("olmo-1b", smoke=True)
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    stacked = jax.tree.map(
        lambda l: np.stack([l, l]) + (0.01 * rng.standard_normal(
            (N_PODS,) + l.shape)).astype(l.dtype), params)
    residuals = jax.tree.map(
        lambda l: (1e-3 * rng.standard_normal(l.shape)).astype(np.float32),
        stacked)
    return stacked, residuals


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, atol=PARAM_ATOL):
    for (p, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                         tree_leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(p))


def _leaf(pods, key=("units", "b0", "mlp", "w_up")):
    stacked, residuals = pods
    leaf, res = stacked, residuals
    for k in key:
        leaf, res = leaf[k], res[k]
    return leaf, res


def test_check_scheme():
    assert tfed.SCHEMES == jfed.SCHEMES
    assert tfed.check_scheme(None) == "none"
    with pytest.raises(ValueError, match="unknown compression scheme"):
        tfed.check_scheme("int4")


def test_stacked_quantiser_is_the_vmapped_one(pods):
    """One block a pod over the stacked leaf: the codes and scales of
    ``jax.vmap(quantize_int8)``, eager, exactly."""
    leaf, _ = _leaf(pods)
    delta = (leaf - leaf[:1]).astype(np.float32) + 1e-3
    qj, sj = jax.vmap(jcomp.quantize_int8)(jnp.asarray(delta))
    q, s = qref.quantize_int8_ref(torch.from_numpy(delta),
                                  block=delta[0].size)
    np.testing.assert_array_equal(q.numpy().reshape(delta.shape),
                                  np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_pod_weighted_mean(pods):
    leaf, _ = _leaf(pods)
    w = np.array([0.25, 0.75], np.float32)
    got = tfed.pod_weighted_mean(torch.from_numpy(leaf), torch.from_numpy(w))
    want = jfed.pod_weighted_mean(jnp.asarray(leaf), jnp.asarray(w))
    assert got.shape == leaf.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PARAM_ATOL)
    assert got[0].data_ptr() != got[1].data_ptr()


def test_init_residuals(pods):
    got = tfed.init_residuals(_t(pods[0]))
    want = jfed.init_residuals(_j(pods[0]))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any()


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_compress_pod_updates(pods, scheme, ef):
    leaf, res = _leaf(pods)
    got = tfed.compress_pod_updates(torch.from_numpy(leaf), scheme,
                                    TOPK_FRAC,
                                    torch.from_numpy(res) if ef else None)
    want = jfed.compress_pod_updates(jnp.asarray(leaf), scheme, TOPK_FRAC,
                                     jnp.asarray(res) if ef else None)
    got, want = (got, want) if ef else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)
        if "int8" in scheme:   # the codes and scales decide it: exact
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if scheme == "none":
        assert got[0] is not None and torch.equal(got[0],
                                                  torch.from_numpy(leaf))


def _scales(target: np.ndarray, scheme: str) -> np.ndarray:
    """Each pod's int8 scale (``amax / 127``) of the encoded target,
    shaped to broadcast over the stacked leaf."""
    t = torch.from_numpy(target)
    if "topk" in scheme:
        t = torch.stack([tfed.topk_sparsify(r, TOPK_FRAC) for r in t])
    amax = t.reshape(t.shape[0], -1).abs().amax(dim=1).numpy()
    return (amax / 127.0).reshape((-1,) + (1,) * (target.ndim - 1))


@pytest.mark.parametrize("scheme", ["int8", "int8+topk"])
def test_compress_pod_updates_jitted_within_one_code(pods, scheme):
    """C7: against the jitted reference each decoded element within one
    code step of its pod (the residual likewise)."""
    leaf, res = _leaf(pods)
    fn = jax.jit(jfed.compress_pod_updates, static_argnums=(1, 2))
    dec_j, res_j = fn(jnp.asarray(leaf), scheme, TOPK_FRAC, jnp.asarray(res))
    dec, new_res = tfed.compress_pod_updates(
        torch.from_numpy(leaf), scheme, TOPK_FRAC, torch.from_numpy(res))
    step = _scales((leaf - leaf[:1]).astype(np.float32) + res, scheme)
    for g, w in ((dec, dec_j), (new_res, res_j)):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert np.all(diff <= step * (1 + 1e-6) + PARAM_ATOL)


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fedavg_pods(pods, scheme, ef):
    stacked, residuals = pods
    w = np.array([1.0, 3.0], np.float32)
    got = tfed.fedavg_pods(_t(stacked), torch.from_numpy(w), scheme,
                           TOPK_FRAC, _t(residuals) if ef else None)
    want = jfed.fedavg_pods(_j(stacked), jnp.asarray(w), scheme, TOPK_FRAC,
                            _j(residuals) if ef else None)
    got, want = (got, want) if ef else ((got,), (want,))
    for g, wt in zip(got, want):
        _close(g, wt)
    for leaf in tree_leaves(got[0]):      # every pod holds the average
        assert torch.equal(leaf[0], leaf[1])


@pytest.mark.parametrize("power", [0.5, 1.0, 2.0])
def test_staleness_discount(power):
    tau = np.arange(8, dtype=np.int32)
    got = tfed.staleness_discount(torch.from_numpy(tau), power)
    want = jfed.staleness_discount(jnp.asarray(tau), power)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=0)


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_compress_deltas(pods, scheme, ef):
    leaf, res = _leaf(pods)
    deltas = (leaf - leaf.mean(axis=0, keepdims=True)).astype(np.float32)
    got = tfed.compress_deltas(torch.from_numpy(deltas), scheme, TOPK_FRAC,
                               torch.from_numpy(res) if ef else None)
    want = jfed.compress_deltas(jnp.asarray(deltas), scheme, TOPK_FRAC,
                                jnp.asarray(res) if ef else None)
    got, want = (got, want) if ef else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)
        if "int8" in scheme:   # the codes and scales decide it: exact
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bmask():
    m = torch.tensor([True, False])
    leaf = torch.zeros((2, 3, 4))
    assert tfed._bmask(m, leaf).shape == (2, 1, 1)


# (arrived, staleness, frac, quorum_frac, n_expected): FedBuff's cases
FEDBUFF_CASES = {
    "all_fresh": ([True, True], [0, 0], None, None, None),
    "lone_stale": ([False, True], [0, 3], None, None, None),
    "partial": ([True, True], [0, 1], [1.0, 0.5], None, None),
    "none_arrived": ([False, False], [0, 0], None, None, None),
    "quorum_met": ([True, False], [2, 0], None, 0.5, None),
    "quorum_not_met": ([True, False], [0, 0], None, 0.6, None),
    "quorum_of_expected_met": ([True, True], [0, 0], None, 0.5, 3),
    "quorum_of_expected_not_met": ([True, True], [0, 0], None, 0.5, 5),
}
HELD = ("none_arrived", "quorum_not_met", "quorum_of_expected_not_met")


def _fedbuff_inputs(pods):
    stacked, residuals = pods
    glob = jax.tree.map(lambda l: np.broadcast_to(
        l.mean(axis=0, keepdims=True), l.shape).astype(l.dtype), stacked)
    pending = jax.tree.map(
        lambda l, g: (l - g).astype(np.float32), stacked, glob)
    return pending, glob, residuals


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", list(FEDBUFF_CASES))
def test_fedbuff_pods(pods, case, scheme, ef):
    arrived, stale, frac, quorum, n_exp = FEDBUFF_CASES[case]
    pending, glob, residuals = _fedbuff_inputs(pods)
    w = np.array([1.0, 2.0], np.float32)
    args = dict(server_lr=0.8, scheme=scheme, topk_frac=TOPK_FRAC,
                staleness_power=0.5, quorum_frac=quorum, n_expected=n_exp)
    arr, st = np.array(arrived), np.array(stale, np.int32)
    fr = None if frac is None else np.array(frac, np.float32)
    got = tfed.fedbuff_pods(
        _t(pending), _t(glob), torch.from_numpy(w), torch.from_numpy(arr),
        torch.from_numpy(st), frac=None if fr is None else
        torch.from_numpy(fr), residuals=_t(residuals) if ef else None,
        **args)
    want = jfed.fedbuff_pods(
        _j(pending), _j(glob), jnp.asarray(w), jnp.asarray(arr),
        jnp.asarray(st), frac=None if fr is None else jnp.asarray(fr),
        residuals=_j(residuals) if ef else None, **args)
    got, want = (got, want) if ef else ((got,), (want,))
    for g, wt in zip(got, want):
        _close(g, wt)
    moved = any(not torch.equal(g, torch.from_numpy(o)) for g, o in
                zip(tree_leaves(got[0]), jax.tree.leaves(glob)))
    assert moved == (case not in HELD)
    if ef:     # the residuals of pods that sent nothing pass through
        for g, r in zip(tree_leaves(got[1]), jax.tree.leaves(residuals)):
            for pod, a in enumerate(arrived):
                if not a:
                    assert torch.equal(g[pod], torch.from_numpy(r[pod]))


def test_want_is_the_stacked_tree():
    cfg = get_config("olmo-1b", smoke=True)
    want = _want(cfg, N_PODS, torch.float32)
    assert all(w.shape[0] == N_PODS and w.dtype == torch.float32
               and w.device.type == "meta" for w in tree_leaves(want))
