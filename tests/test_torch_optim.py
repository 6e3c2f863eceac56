"""The port's optimizers, schedules and token batcher against the JAX
package's, on the CPU.

Schedules: every lr at steps 0-40 (int32 steps, as the train step feeds
them) must equal the reference's float32 value bit for bit; the port
takes the reference's arithmetic on the host and its ``cos``/``pow`` from
the C library, which is what XLA's CPU ``cos``/``pow`` call.
``apply_updates``: the same numpy parameter and gradient trees (smoke
olmo-1b's stacked tree, whose per-layer norm vectors are 2-D and take
decay, plus a bf16 leaf and a 1-D leaf) through three steps of sgd,
momentum and adamw, with and without the clip, float32 and bf16 moments:
parameters, moments and the gradient norm within ``RTOL`` (of each
leaf's largest magnitude; bf16 moments also within one bf16 step), as
the constants below explain. ``TokenBatcher``: the reference's batches, equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenBatcher as JBatcher
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.data import TokenBatcher, lm_tokens
from repro_torch.models.convert import _tensor
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

# each leaf within RTOL of its largest magnitude: the same float32
# operations in the same order, but XLA's CPU code contracts ``a*b + c``
# into one fused multiply-add where PyTorch rounds twice, and the global
# norm's sum runs in another order, so a last bit may differ (and a
# moment's cancellation carries it up); a bf16 moment may then round to
# the neighbouring bf16 value (BF16_ULP of the element), which moves
# that element's parameter by up to lr * BF16_ULP a step
RTOL = 2e-6
BF16_ULP = 2.0 ** -7   # bf16 keeps 8 significant bits


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-3),
    lambda m: m.warmup_cosine(3e-3, 20, 40),
    lambda m: m.warmup_cosine(3e-3, 20, 60),
    lambda m: m.warmup_cosine(1e-3, 5, 4000, final_frac=0.2),
    lambda m: m.warmup_cosine(3e-3, 0, 30),
    lambda m: m.inverse_sqrt(3e-3, 20),
    lambda m: m.inverse_sqrt(2e-4, 7),
], ids=["constant", "cosine40", "cosine60", "cosine4000", "cosine_nowarm",
        "invsqrt20", "invsqrt7"])
def test_schedule_equals_reference_float32(make):
    jfn, tfn = make(jsched), make(tsched)
    for s in range(41):
        want = np.asarray(jfn(jnp.asarray(s, jnp.int32)), np.float32)
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy().tobytes() == want.tobytes(), (s, got, want)


def _trees(seed: int, n_steps: int):
    """A parameter tree shaped like smoke olmo-1b's stacked params (2-D
    stacked norm scales included) plus a bf16 matrix and a 1-D bias,
    and ``n_steps`` gradient trees, as numpy."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0, dtype=np.float32):
        return (rng.standard_normal(shape) * scale).astype(dtype)

    params = {
        "embed": draw((128, 64), 0.02),
        "final_norm": {"scale": draw((64,)) + 1},
        "units": {"b0": {"mix_norm": {"scale": draw((2, 64)) + 1},
                         "mixer": {"wq": draw((2, 64, 64), 0.1)}}},
        "bf16": draw((16, 8)).astype(jnp.bfloat16),
        "bias": draw((8,)),
    }
    grads = [jax.tree.map(
        lambda p: draw(p.shape, 0.3).astype(p.dtype), params)
        for _ in range(n_steps)]
    return params, grads


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return _tensor(tree)


def _assert_tree_close(got, want, what, atol=0.0):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(flat, tree_leaves(got)):
        w = np.asarray(w)
        where = f"{what}{jax.tree_util.keystr(path)}"
        assert g.dtype == _tensor(w).dtype, where
        w32 = w.astype(np.float32)
        scale = float(np.abs(w32).max()) if w32.size else 0.0
        rtol = BF16_ULP if g.dtype == torch.bfloat16 else 0.0
        np.testing.assert_allclose(g.float().numpy(), w32, rtol=rtol,
                                   atol=RTOL * scale + atol, err_msg=where)


@pytest.mark.parametrize("name,clip,state_dtype", [
    ("sgd", 1.0, "float32"), ("sgd", 0.0, "float32"),
    ("momentum", 1.0, "float32"), ("momentum", 0.0, "bfloat16"),
    ("adamw", 1.0, "float32"), ("adamw", 0.0, "float32"),
    ("adamw", 1.0, "bfloat16"), ("adamw", 0.5, "bfloat16"),
])
def test_apply_updates_equals_reference(name, clip, state_dtype):
    params, grads = _trees(0, 3)
    jcfg = jopt.OptimizerConfig(name=name, lr=3e-3, grad_clip=clip,
                                state_dtype=state_dtype)
    tcfg = topt.OptimizerConfig(name=name, lr=3e-3, grad_clip=clip,
                                state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, jcfg)
    tp = _to_torch(params)
    ts = topt.init_opt_state(tp, tcfg)
    lr_fn = jsched.warmup_cosine(3e-3, 1, 3)
    for i, g in enumerate(grads):
        jlr = lr_fn(js.step)
        jp, js, jn = jopt.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), js, jcfg, lr=jlr)
        tp, ts, tn = topt.apply_updates(
            tp, _to_torch(g), ts, tcfg,
            lr=tsched.warmup_cosine(3e-3, 1, 3)(ts.step))
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        bf16_steps = (i + 1) if state_dtype == "bfloat16" else 0
        _assert_tree_close(tp, jp, f"{name} step {i} params",
                           atol=3e-3 * BF16_ULP * bf16_steps)
        _assert_tree_close(ts.mu, js.mu, f"{name} step {i} mu")
        _assert_tree_close(ts.nu, js.nu, f"{name} step {i} nu")


def test_decay_takes_the_stacked_norm_vectors():
    """Decay where the stored leaf has two or more dimensions: the
    stacked norm scales (n_units, d) decay, the unstacked final norm
    (d,) does not, as in the reference."""
    params, _ = _trees(1, 0)
    tp = _to_torch(params)
    zero = tree_map(torch.zeros_like, tp)
    cfg = topt.OptimizerConfig(lr=0.5, grad_clip=0.0, weight_decay=0.1)
    new, _, _ = topt.apply_updates(tp, zero, topt.init_opt_state(tp, cfg),
                                   cfg)
    stacked = tp["units"]["b0"]["mix_norm"]["scale"]
    assert torch.equal(new["final_norm"]["scale"], tp["final_norm"]["scale"])
    assert torch.equal(new["bias"], tp["bias"])
    assert not torch.equal(new["units"]["b0"]["mix_norm"]["scale"], stacked)
    torch.testing.assert_close(new["units"]["b0"]["mix_norm"]["scale"],
                               stacked * (1 - 0.5 * 0.1), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("pods,pod", [(1, 0), (2, 1), (3, 2)])
def test_token_batcher_equals_reference(pods, pod):
    tokens = lm_tokens(5_000, 128, seed=0)
    want = iter(JBatcher(tokens, 4, 16, seed=pod, pod_index=pod,
                         n_pods=pods))
    got = iter(TokenBatcher(tokens, 4, 16, seed=pod, pod_index=pod,
                            n_pods=pods))
    # past one epoch (5,000 / pods tokens in blocks of 17, batches of 4)
    for _ in range(30):
        w, g = next(want), next(got)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
