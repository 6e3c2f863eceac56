"""The port's Mixture-of-Experts layer against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_apply`` and ``repro.models.moe.moe_apply``
get the same float32 inputs (numpy, seeded) and the same weights (the
reference's ``moe_init`` carried across). ``y`` and ``aux`` must agree
within 2e-5 (float32 products summed in another order) and the routing
itself (experts, positions, kept slots) must equal the reference's
exactly: which tokens are dropped is discrete. Cases: the smoke config's
dropless capacity, ``capacity_factor=1.0`` (drops), one group and
several (``group_tokens`` small), top-2 of 4 and of 8 experts, and a
router built so that three experts tie exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from test_torch_lm import _torch_cfg

TOL = dict(atol=2e-5, rtol=2e-5)


def _cfg(n_experts=4, top_k=2, capacity_factor=None, group_tokens=None,
         dense_residual=False):
    """mixtral's smoke config with the MoE fields replaced; dropless
    (``n_experts / top_k``, as ``smoke()`` sets it) unless
    ``capacity_factor`` is given."""
    jcfg = jcfgs.get_config("mixtral-8x22b", smoke=True)
    kw = {"n_experts": n_experts, "top_k": top_k,
          "dense_residual": dense_residual,
          "capacity_factor": (n_experts / top_k if capacity_factor is None
                              else capacity_factor)}
    if group_tokens is not None:
        kw["group_tokens"] = group_tokens
    return jcfg.replace(moe=dataclasses.replace(jcfg.moe, **kw))


def _params(jcfg, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return {k: np.array(v) for k, v in p.items()}


def _dispatch_ref(jcfg, params, xt, capacity):
    """The reference's routing of one group as (experts, positions,
    kept): read off its one-hot dispatch tensor."""
    e = jcfg.moe
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(params["router"]),
                           axis=-1)
    gate_val, gate_idx = jax.lax.top_k(probs, e.top_k)
    dispatch, _ = jmoe._dispatch_combine(gate_idx, gate_val, xt.shape[0],
                                         e.n_experts, capacity)
    d = np.asarray(dispatch)                       # (n, E, C)
    idx = np.asarray(gate_idx)
    pos = np.full(idx.shape, -1)
    for t in range(idx.shape[0]):
        for s in range(idx.shape[1]):
            hit = np.nonzero(d[t, idx[t, s]])[0]
            if hit.size:
                pos[t, s] = hit[0]
    return idx, pos


def _assert_moe_matches(jcfg, x, params, capacity_factor=None):
    want_y, want_aux = jmoe.moe_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jcfg, capacity_factor)
    cfg = _torch_cfg(jcfg)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    got_y, got_aux = tmoe.moe_apply(tp, torch.as_tensor(x), cfg,
                                    capacity_factor)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()

    # the routing, group by group, exactly
    e = jcfg.moe
    N = x.shape[0] * x.shape[1]
    g = jmoe._n_groups(N, e.group_tokens)
    assert tmoe._n_groups(N, e.group_tokens) == g
    n = N // g
    cf = e.capacity_factor if capacity_factor is None else capacity_factor
    capacity = min(int(max(e.top_k, cf * n * e.top_k / e.n_experts)), n)
    dropped = 0
    for xi in x.reshape(g, n, -1):
        want_idx, want_pos = _dispatch_ref(jcfg, params, xi, capacity)
        _, idx, _, pos, keep = tmoe._route(torch.as_tensor(xi),
                                           tp["router"], e.top_k, capacity)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        np.testing.assert_array_equal(
            np.where(keep.numpy(), pos.numpy(), -1), want_pos)
        dropped += int((~keep).sum())
    return g, capacity, dropped


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


@pytest.mark.parametrize("n_experts", [4, 8])
@pytest.mark.parametrize("capacity_factor,group_tokens,want_g", [
    (None, None, 1),       # smoke: dropless, one group
    (1.0, None, 1),        # drops, one group
    (None, 8, 4),          # dropless, four groups of 8
    (1.0, 8, 4),           # drops in each of four groups
])
def test_moe_apply_matches_reference(n_experts, capacity_factor,
                                     group_tokens, want_g):
    jcfg = _cfg(n_experts=n_experts, capacity_factor=capacity_factor,
                group_tokens=group_tokens)
    x = _x((2, 16, jcfg.d_model), seed=n_experts)
    g, capacity, dropped = _assert_moe_matches(jcfg, x, _params(jcfg))
    assert g == want_g
    if capacity_factor is None:
        assert dropped == 0                    # dropless capacity
    else:
        assert dropped > 0, capacity           # the case reaches drops


def test_moe_apply_capacity_factor_argument():
    """``capacity_factor`` given to the call overrides the config's."""
    jcfg = _cfg(n_experts=8)
    x = _x((2, 12, jcfg.d_model), seed=3)
    *_, dropped = _assert_moe_matches(jcfg, x, _params(jcfg, 1),
                                      capacity_factor=0.5)
    assert dropped > 0


def test_router_tie_breaks_by_the_lower_index():
    """Experts 0, 2 and 3 get the same logit for every token (exact
    products of quarters), expert 1 a lower one: top-2 takes 0 and 2,
    in that order, as ``jax.lax.top_k`` does; with capacity 1.0 the
    slot order then decides the drops."""
    jcfg = _cfg(n_experts=4, capacity_factor=1.0)
    params = _params(jcfg)
    rng = np.random.default_rng(5)
    col = rng.integers(-2, 3, jcfg.d_model).astype(np.float32) / 4
    router = np.stack([col, col - 0.25, col, col], axis=1)
    params["router"] = router.astype(np.float32)
    # positive inputs: expert 1's logit is 0.25 * sum(x) below the others'
    x = rng.integers(1, 5, (2, 8, jcfg.d_model)).astype(np.float32) / 4
    _assert_moe_matches(jcfg, x, params)
    _, idx, _, _, _ = tmoe._route(torch.as_tensor(x.reshape(16, -1)),
                                  torch.as_tensor(router), 2, 8)
    assert (idx.numpy() == [0, 2]).all()


def test_top_k_is_stable_on_ties():
    p = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe._top_k(p, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n_tokens,group_tokens", [
    (1, 8192), (8192, 8192), (16384, 8192), (32768, 8192), (24, 8),
    (40, 8), (64, 8), (7, 1), (96, 16)])
def test_n_groups_matches_reference(n_tokens, group_tokens):
    assert (tmoe._n_groups(n_tokens, group_tokens)
            == jmoe._n_groups(n_tokens, group_tokens))


def test_moe_init_stacks_experts_in_param_dtype():
    jcfg = _cfg(n_experts=8).replace(param_dtype="bfloat16")
    cfg = _torch_cfg(jcfg)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.bfloat16
    E, D, F = 8, cfg.d_model, cfg.moe.d_ff_expert
    # each expert drawn apart, at the reference's scale
    w = p["w_gate"].float()
    assert abs(float(w.std()) - D ** -0.5) < 0.01
    assert not torch.equal(w[0], w[1])
    assert abs(float(p["w_down"].float().std()) - F ** -0.5) < 0.01
    assert abs(float(p["router"].float().std()) - 0.02) < 0.005
    assert p["w_down"].shape == (E, F, D)
