"""The port's int8 KV cache against the JAX package's, on the CPU.

The reference quantises each cached (batch, slot) row symmetrically:
``scale = amax / 127`` (1 for a zero row), codes ``round(x / scale)``
half to even, clipped to +-127. Its functions run here eagerly (no
``jit``: under ``jit`` XLA may turn the division into a product with
``f32(1/127)``, caveat C7), and the port must give the same codes and
scales bit for bit: ``_quant_rows`` on numpy rows, and the caches that
``attn_prefill`` and ``attn_decode`` write. For those, the projections
are made exact (inputs and weights in multiples of 1/8 over 64 inputs,
no RoPE), so both sides quantise the same k and v. The attention
outputs agree within 2e-5 (float32 products summed in another order).
Covered: a prompt shorter than the cache (``S < cap``), a window
shorter than the prompt (``S >= cap``: payload and scales rolled), and
a window whose ring wraps during decode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.configs.base import ATTN as JATTN
from repro.configs.base import LayerSpec as JLayerSpec
from repro.models import attention as jattn
from repro_torch.configs.base import ATTN, LayerSpec
from repro_torch.models import attention as tattn
from test_torch_lm import _torch_cfg

TOL = dict(atol=2e-5, rtol=2e-5)


def _rows(seed, shape=(2, 5, 32)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32) * rng.uniform(
        0.01, 30, shape[:-1] + (1,)).astype(np.float32)
    x[0, 0] = 0.0                                   # a zero row: scale 1
    # amax 254 -> scale 2: x / scale lands on halves, rounded to even
    x[1, 1, :6] = [254.0, 1.0, 3.0, 5.0, -5.0, -1.0]
    x[1, 1, 6:] = 0.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_bit_for_bit(seed, dtype):
    x = _rows(seed)
    jx = jnp.asarray(x, dtype)
    want_q, want_s = jattn._quant_rows(jx)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got_q, got_s = tattn._quant_rows(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if seed == 0:
        assert got_q[1, 1, :6].tolist() == [127, 0, 2, 2, -2, 0]
        assert float(got_s[0, 0]) == 1.0
    got_d = tattn._dequant_rows(got_q, got_s, tx.dtype)
    want_d = jattn._dequant_rows(want_q, want_s, jx.dtype)
    np.testing.assert_array_equal(got_d.float().numpy(),
                                  np.asarray(want_d, np.float32))


def test_int8_layer_cache_equals_reference():
    jcfg = jcfgs.get_config("olmo-1b", smoke=True).replace(
        kv_cache_dtype="int8")
    cfg = _torch_cfg(jcfg)
    for window in (None, 8):
        want = jattn.init_layer_cache(jcfg, JLayerSpec(JATTN, window), 3, 20)
        got = tattn.init_layer_cache(cfg, LayerSpec(ATTN, window), 3, 20,
                                     device="cpu")
        assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
        for key, value in want.items():
            assert str(got[key].dtype).removeprefix("torch.") == str(
                value.dtype)
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(value))


def _exact(rng, shape, scale=1):
    """Multiples of 1/8 in [-1, 1] * scale: products and sums over 64
    inputs stay exact in float32."""
    return (rng.integers(-8, 9, shape) / 8 * scale).astype(np.float32)


def _setup(window, seed):
    jcfg = jcfgs.get_config("olmo-1b", smoke=True).replace(
        kv_cache_dtype="int8", use_rope=False, n_kv_heads=2)
    rng = np.random.default_rng(seed)
    D, H, K, Dh = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_head
    params = {"wq": _exact(rng, (D, H * Dh)), "wk": _exact(rng, (D, K * Dh)),
              "wv": _exact(rng, (D, K * Dh)),
              "wo": _exact(rng, (H * Dh, D), 0.125)}
    spec = JLayerSpec(JATTN, window)
    cfg = _torch_cfg(jcfg)
    return jcfg, cfg, params, spec, LayerSpec(ATTN, window), rng


def _assert_cache_bits(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value))


@pytest.mark.parametrize("window,prompt,max_len,n_decode", [
    (None, 6, 16, 6),     # S < cap, no window
    (8, 12, 32, 6),       # S >= cap: the last 8 tokens, rolled
    (8, 5, 32, 9),        # S < cap; the ring of 8 wraps during decode
])
def test_int8_prefill_and_decode_bit_for_bit(window, prompt, max_len,
                                             n_decode):
    jcfg, cfg, params, jspec, tspec, rng = _setup(window, prompt)
    B = 2
    x = _exact(rng, (B, prompt, jcfg.d_model))
    pos = np.tile(np.arange(prompt, dtype=np.int32), (B, 1))
    jcache = jattn.init_layer_cache(jcfg, jspec, B, max_len)
    tcache = tattn.init_layer_cache(cfg, tspec, B, max_len, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    want, jcache = jattn.attn_prefill(jp, jnp.asarray(x), jcfg, jspec,
                                      jnp.asarray(pos), jcache)
    got, tcache = tattn.attn_prefill(tp, torch.as_tensor(x), cfg, tspec,
                                     torch.as_tensor(pos), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_bits(tcache, jcache)
    if window is not None and prompt >= window:
        assert tcache["k"].shape[1] == window
        assert not (tcache["k_scale"] == 1).any()      # every slot written
    elif window is None:
        assert (tcache["k_scale"][:, prompt:] == 1).all()
    for step in range(n_decode):
        xt = _exact(rng, (B, 1, jcfg.d_model))
        p = prompt + step
        want, jcache = jattn.attn_decode(jp, jnp.asarray(xt), jcfg, jspec, p,
                                         jcache)
        got, tcache = tattn.attn_decode(tp, torch.as_tensor(xt), cfg, tspec,
                                        p, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_cache_bits(tcache, jcache)
    if window is not None:
        assert prompt + n_decode > window                # the ring wrapped


def test_prefill_attends_over_the_unquantised_keys():
    """The prefill's output is the bf16/float32 cache's: only what is
    cached is quantised."""
    jcfg, cfg, params, _, tspec, rng = _setup(None, 3)
    x = torch.as_tensor(rng.standard_normal((2, 7, jcfg.d_model),
                                            np.float32))
    pos = torch.arange(7, dtype=torch.int32).expand(2, 7)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    out8, c8 = tattn.attn_prefill(
        tp, x, cfg, tspec, pos,
        tattn.init_layer_cache(cfg, tspec, 2, 16, device="cpu"))
    f32 = cfg.replace(kv_cache_dtype="bfloat16")
    out, c = tattn.attn_prefill(
        tp, x, f32, tspec, pos,
        tattn.init_layer_cache(f32, tspec, 2, 16, device="cpu"))
    assert torch.equal(out8, out)
    assert c8["k"].dtype == torch.int8 and c["k"].dtype == torch.float32
    deq = tattn._dequant_rows(c8["k"], c8["k_scale"], torch.float32)
    # within half a step of each row's scale
    err = (deq[:, :7] - c["k"][:, :7]).abs()
    assert bool((err <= c8["k_scale"][:, :7, None] / 2 + 1e-7).all())
