"""The port's RG-LRU scan and block against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

* ``rglru_scan_ref`` (the plain version of the Hopper kernel K6) against
  the reference's ``rglru_scan_ref`` and its Pallas kernel
  ``rglru_scan_fwd`` run in interpret mode: float32 and bfloat16 inputs
  (both sides upcast the same bf16 values and compute in float32), with
  and without ``h0``, whole and ragged S and R (the Pallas kernel pads
  to its 128 × 128 blocks, the port masks). Within 1e-5: the same
  float32 recurrence, rounded in another order where a compiler fuses
  the multiply and add.
* The model's ``rglru_scan`` (gates, then the scan), ``rglru_full`` and
  ``rglru_prefill`` then ``rglru_decode`` (outputs and ``h``/``conv``
  caches) against ``repro.models.rglru`` on the reference's own block
  parameters, within 2e-5 in float32: the reference runs an associative
  scan and folds ``a_0 * h0`` into the first input, the port a
  sequential scan from ``h0``.
* A plain float32 emulation of K6's chunked order (chunk pairs of
  ``prod a`` and the scan from 0, combined in order from the window's
  carry, then each chunk rescanned from the ``h`` entering it, the
  window's last ``h`` carried on; ``fmaf`` where the kernel has it) at
  the kernel's chunk and window lengths, against both plain versions
  within K6's card tolerance (1e-5 of the largest ``|h|``) on the hard
  inputs: decays in [0.99, 0.9999] and in [0, 0.05] over 2048 steps,
  with and without ``h0``, and S off the window.
* The dispatch on CPU tensors, and the kernel's wrapper refusing them.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.kernels.rglru.kernel import rglru_scan_fwd
from repro.kernels.rglru.ref import rglru_scan_ref as jax_scan_ref
from repro.models import rglru as jrglru
from repro_torch import _cuda
from repro_torch.configs import get_config
from repro_torch.kernels.rglru import kernel, ops, ref
from repro_torch.models import rglru as trglru

TOL = dict(atol=2e-5, rtol=2e-5)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, S, R): the shapes of tests/test_kernels.py, ragged S and R off the
# Pallas blocks, one step, one channel
SHAPES = [(2, 200, 96), (1, 64, 256), (3, 17, 33), (2, 300, 200), (1, 1, 5),
          (2, 9, 1)]


def _scan_inputs(B, S, R, seed=0, h0=True):
    """a in (0, 1), b ~ 0.1 N(0, 1), h0 ~ N(0, 1), as float32 numpy."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, R))))
    b = rng.standard_normal((B, S, R)) * 0.1
    h = rng.standard_normal((B, R)) if h0 else None
    return (a.astype(np.float32), b.astype(np.float32),
            None if h is None else h.astype(np.float32))


def _both(arrays, jdt, tdt):
    """JAX and torch copies; a and b in the given dtype, h0 float32."""
    a, b, h = arrays
    jx = [jnp.asarray(a, jdt), jnp.asarray(b, jdt),
          None if h is None else jnp.asarray(h)]
    tx = [torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt),
          None if h is None else torch.as_tensor(h)]
    return jx, tx


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,R", SHAPES)
def test_ref_matches_jax_ref_and_pallas_kernel(B, S, R, dtype, h0):
    (ja, jb, jh), (ta, tb, th) = _both(_scan_inputs(B, S, R, S + R, h0),
                                       *DTYPES[dtype])
    got = ref.rglru_scan_ref(ta, tb, th)
    assert got.dtype == torch.float32 and got.shape == (B, S, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_scan_ref(ja, jb,
                                                                    jh)),
                               **SCAN_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(rglru_scan_fwd(ja, jb, jh, interpret=True)),
        **SCAN_TOL)


def test_ref_carries_the_state():
    """One scan over S equals two over its halves, the second from the
    first's last state."""
    a, b, h = (torch.as_tensor(x) for x in _scan_inputs(2, 41, 7, seed=5))
    whole = ref.rglru_scan_ref(a, b, h)
    first = ref.rglru_scan_ref(a[:, :20], b[:, :20], h)
    second = ref.rglru_scan_ref(a[:, 20:], b[:, 20:], first[:, -1])
    torch.testing.assert_close(torch.cat([first, second], 1), whole, **TOL)


# K6 on the card is held to its plain version within K6_TOL of the plain
# version's largest |h| (chip_smoke.py, tests/test_torch_cuda.py)
K6_TOL = 1e-5


def _fma(x, y, z):
    """float32 fmaf(x, y, z): the product is exact in float64."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _chunked_emulation(a, b, h0):
    """h of K6's order of operations, in float32 numpy: windows of
    ``kernel.WINDOW`` steps, chunks of ``kernel.CHUNK``; zeros past S."""
    B, S, R = a.shape
    W, L = kernel.WINDOW, kernel.CHUNK
    nc = W // L
    out = np.empty((B, S, R), np.float32)
    carry = np.zeros((B, R), np.float32) if h0 is None else h0
    for t0 in range(0, S, W):
        n = min(W, S - t0)
        aw = np.zeros((B, W, R), np.float32)
        bw = np.zeros((B, W, R), np.float32)
        aw[:, :n], bw[:, :n] = a[:, t0:t0 + n], b[:, t0:t0 + n]
        ac, bc = aw.reshape(B, nc, L, R), bw.reshape(B, nc, L, R)
        pa = np.ones((B, nc, R), np.float32)
        pb = np.zeros((B, nc, R), np.float32)
        for k in range(L):
            pa = pa * ac[:, :, k]
            pb = _fma(ac[:, :, k], pb, bc[:, :, k])
        hin = np.empty((B, nc, R), np.float32)
        h = carry
        for j in range(nc):
            hin[:, j] = h
            h = _fma(pa[:, j], h, pb[:, j])
        hw = np.empty((B, nc, L, R), np.float32)
        h = hin
        for k in range(L):
            h = _fma(ac[:, :, k], h, bc[:, :, k])
            hw[:, :, k] = h
        hw = hw.reshape(B, W, R)
        out[:, t0:t0 + n] = hw[:, :n]
        carry = hw[:, -1]
    return out


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("lo,hi,S", [(0.99, 0.9999, 2048), (0.0, 0.05, 2048),
                                     (0.99, 0.9999, 2000), (0.0, 1.0, 333)])
def test_chunked_order_within_card_tolerance(lo, hi, S, h0):
    rng = np.random.default_rng(S + int(h0))
    B, R = 2, 64
    a = (lo + (hi - lo) * rng.random((B, S, R))).astype(np.float32)
    b = (rng.standard_normal((B, S, R)) * 0.1).astype(np.float32)
    h = rng.standard_normal((B, R)).astype(np.float32) if h0 else None
    got = _chunked_emulation(a, b, h)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    want = ref.rglru_scan_ref(ta, tb, None if h is None else
                              torch.as_tensor(h)).numpy()
    jwant = np.asarray(jax_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                    None if h is None else jnp.asarray(h)))
    for plain in (want, jwant):
        err = np.abs(got - plain).max() / np.abs(plain).max()
        assert err <= K6_TOL, err


def test_chunk_lengths_match_the_source():
    """The emulation's lengths are the CUDA kernel's."""
    src = (_cuda.CSRC / "rglru_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kC") == kernel.CHANNELS
    assert const("kL") == kernel.CHUNK
    assert const("kNC") * const("kL") == kernel.WINDOW
    assert "rglru_chunked_scan_kernel" in src


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _gates(B, S, R, seed):
    """u, r, i (B, S, R), lam (R,), h0 (B, R) as float32 numpy, with r
    and i in (0, 1) as the sigmoids give them and lam spread over
    softplus's range."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, R))
    r, i = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, R))))
            for _ in range(2))
    lam = rng.uniform(-4.0, 6.0, R)
    h0 = rng.standard_normal((B, R))
    return [x.astype(np.float32) for x in (u, r, i, lam, h0)]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,S,R", [(2, 24, 64), (1, 7, 33)])
def test_model_scan_matches_reference(B, S, R, h0):
    u, r, i, lam, h = _gates(B, S, R, S)
    want = jrglru.rglru_scan(*(jnp.asarray(x) for x in (u, r, i, lam)), 8.0,
                             jnp.asarray(h) if h0 else None)
    got = trglru.rglru_scan(*(torch.as_tensor(x) for x in (u, r, i, lam)),
                            8.0, torch.as_tensor(h) if h0 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _block(seed=0):
    """recurrentgemma's smoke config (both packages) and the reference's
    block parameters as numpy and torch."""
    jcfg = jcfgs.get_config("recurrentgemma-2b", smoke=True)
    jp = jrglru.rglru_block_init(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    return jcfg, get_config("recurrentgemma-2b", smoke=True), jp, tp


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


def test_block_init_matches_reference_leaves():
    jcfg, cfg, jp, _ = _block()
    got = trglru.rglru_block_init(torch.Generator().manual_seed(0), cfg)
    assert set(got) == set(jp)
    for key, value in jp.items():
        assert tuple(got[key].shape) == value.shape, key
        assert got[key].dtype == torch.float32
    assert torch.equal(got["lam"], torch.full((64,), 2.0))
    meta = trglru.rglru_block_init(None, cfg, device="meta")
    assert meta["w_a"].is_meta and meta["w_a"].shape == (64, 64)


def test_full_matches_reference():
    jcfg, cfg, jp, tp = _block(1)
    x = _x(2, 19, 64, 1)
    want = jrglru.rglru_full(jp, jnp.asarray(x), jcfg)
    got = trglru.rglru_full(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_decode_match_reference():
    """A prefill over 13 tokens, then 4 one-token decode steps: outputs
    and both caches after every step."""
    jcfg, cfg, jp, tp = _block(2)
    x = _x(2, 17, 64, 2)
    jcache = jrglru.init_rglru_cache(jcfg, 2)
    cache = trglru.init_rglru_cache(cfg, 2)
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].shape == (2, 3, 64)
    h_buf = cache["h"]

    def check(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in ("h", "conv"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), **TOL)

    want, jcache = jrglru.rglru_prefill(jp, jnp.asarray(x[:, :13]), jcfg,
                                        None, None, jcache)
    got, new = trglru.rglru_prefill(tp, torch.as_tensor(x[:, :13]), cfg,
                                    None, None, cache)
    assert new["h"] is h_buf                     # written in place
    check(got, want)
    for t in range(13, 17):
        want, jcache = jrglru.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                           jcfg, None, t, jcache)
        got, _ = trglru.rglru_decode(tp, torch.as_tensor(x[:, t:t + 1]), cfg,
                                     None, t, cache)
        check(got, want)


# ---------------------------------------------------------------------------
# dispatch and wrapper on the CPU
# ---------------------------------------------------------------------------


def test_ops_on_cpu_takes_the_plain_version():
    a, b, h = (torch.as_tensor(x) for x in _scan_inputs(2, 30, 20, seed=9))
    before = kernel.launches
    assert torch.equal(ops.rglru_scan(a, b, h), ref.rglru_scan_ref(a, b, h))
    assert kernel.launches == before
    assert _cuda._lib is None


def test_ops_on_cpu_keeps_gradients():
    a, b, h = (torch.as_tensor(x) for x in _scan_inputs(1, 12, 4, seed=10))
    b.requires_grad_()
    ops.rglru_scan(a, b, h).sum().backward()
    assert b.grad is not None and torch.isfinite(b.grad).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    a, b, h = (torch.as_tensor(x) for x in _scan_inputs(1, 8, 4, seed=11))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.rglru_scan_cuda(a, b, h)
    assert kernel.launches == before
    assert _cuda._lib is None


def test_rglru_source_is_built():
    assert "rglru_scan.cu" in _cuda.SOURCES
    assert (_cuda.CSRC / "rglru_scan.cu").exists()
