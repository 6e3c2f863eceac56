"""The port's int8 quantiser against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

* The plain K3/K3' (``quantize_int8_ref``, ``dequantize_int8_ref``,
  ``roundtrip_ref``) against the reference's ``kernels/quant/ref.py``,
  bit for bit: the grid of ``tests/test_kernels.py`` (shapes x blocks
  {64, 256, 4096}) in float32 and bfloat16, all-zero blocks, exact .5
  ties, ragged tails, ``n = 0`` and ``block >= n``.
* The same against the reference's Pallas kernels run in interpret mode
  (``repro.kernels.quant.ops``). Under ``jit`` XLA rewrites the
  kernel's ``amax / 127.0`` into ``amax * (1 / 127)``, which rounds apart
  from the division on some blocks (ROADMAP caveat C7). So each block is
  held bit for bit where the two scales agree, and where they do not the
  Pallas scale must be exactly that product and its ``q`` exactly the
  quantisation under it; the dequantisation (a product only) is bit for
  bit everywhere.
* At ``block = n`` the plain K3 is the FL half's per-tensor quantiser:
  bit for bit against ``repro.fl.compression.quantize_int8`` on the
  CNN's leaf shapes, and so is the port's ``fl.compression``.
* The plain K3 on quotients that a multiply by ``1 / scale`` would round
  apart from the IEEE division (normal data at scales from 1e-30 to
  1e30, bfloat16 values, values within a few ulps of a tie, exact ties,
  subnormal values and scales): bit for bit against the definition in
  numpy, and against the reference's plain K3 where no value or scale is
  subnormal (XLA on the CPU flushes them to zero).
* The dispatch on CPU tensors, and the kernels' wrappers refusing them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import compression as jcomp
from repro.kernels.quant import ops as jops
from repro.kernels.quant import ref as jref
from repro_torch import _cuda
from repro_torch.fl import compression as tcomp
from repro_torch.kernels.quant import kernel, ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's shapes, a ragged tail past one and many blocks,
# one element
SHAPES = [(100,), (1000, 37), (5, 5, 5), (4097,), (1,)]
BLOCKS = [64, 256, 4096]


def _normal(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _zeros_mixed():
    """Three blocks of 64: all zero, normal, all zero with a -0.0."""
    x = np.zeros(192, np.float32)
    x[64:128] = _normal(64, seed=3)
    x[130] = -0.0
    return x


def _ties():
    """Blocks of 8 whose scales are powers of two, so that x / scale lands
    exactly on .5: 127 -> scale 1, 254 -> scale 2, 63.5 -> scale 0.5."""
    return np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0,
                     1.0, 3.0, 5.0, -1.0, -3.0, -253.0, 253.0, -254.0,
                     0.25, 0.75, 1.25, -0.25, -0.75, 62.75, -63.25, 63.5],
                    np.float32)


# (name, array, block): zeros, ties, ragged, block >= n, n = 0
SPECIAL = [
    ("zeros", np.zeros(300, np.float32), 64),
    ("zeros_mixed", _zeros_mixed(), 64),
    ("ties", _ties(), 8),
    ("ties_one_block", _ties()[:8], 8),
    ("ragged_tail", _normal(1000, seed=4), 300),
    ("block_is_n", _normal(300, seed=5), 300),
    ("block_above_n", _normal(300, seed=6), 4096),
    ("block_one", _normal(17, seed=7), 1),
    ("large_values", _normal(513, seed=8, scale=1e30), 64),
    ("tiny_values", _normal(513, seed=9, scale=1e-30), 64),
    ("empty", np.zeros(0, np.float32), 4096),
]


def _both(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _bits(t: torch.Tensor) -> bytes:
    return t.numpy().tobytes()


def _assert_equal_to_reference(xj, xt, block):
    q, s = ref.quantize_int8_ref(xt, block)
    qj, sj = jref.quantize_int8_ref(xj, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _bits(q) == np.asarray(qj).tobytes()
    assert _bits(s) == np.asarray(sj).tobytes()
    deq = ref.dequantize_int8_ref(q, s, block)
    assert _bits(deq) == np.asarray(
        jref.dequantize_int8_ref(qj, sj, block)).tobytes()
    rt = ref.roundtrip_ref(xt, block)
    assert rt.shape == xt.shape
    assert _bits(rt) == np.asarray(jref.roundtrip_ref(xj, block)).tobytes()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_reference_ref(shape, block, dtype):
    xj, xt = _both(_normal(shape, seed=len(shape) + block), dtype)
    _assert_equal_to_reference(xj, xt, block)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,x,block", SPECIAL, ids=[s[0] for s in SPECIAL])
def test_plain_equals_reference_ref_special(name, x, block, dtype):
    xj, xt = _both(x, dtype)
    _assert_equal_to_reference(xj, xt, block)


def test_ties_round_half_to_even():
    q, s = ref.quantize_int8_ref(torch.from_numpy(_ties()), 8)
    assert s.tolist() == [1.0, 2.0, 0.5]
    assert q.tolist() == [0, 2, 2, 0, -2, -2, 126, 127,
                          0, 2, 2, 0, -2, -126, 126, -127,
                          0, 2, 2, 0, -2, 126, -126, 127]


def _assert_equal_to_pallas(x32: np.ndarray, xj, xt, block):
    """Block by block as the module docstring says."""
    q, s = ref.quantize_int8_ref(xt, block)
    qj, sj = (np.asarray(a) for a in jops.quantize_int8(xj, block=block))
    q, s = q.numpy(), s.numpy()
    n = x32.size
    blk = ref.block_size(block, n)
    flat = np.pad(torch.from_numpy(x32).to(xt.dtype).float().numpy().ravel(),
                  (0, q.size - n)).reshape(-1, blk)
    same = s == sj
    assert same.mean() > 0.5       # the rewrite moves a minority of blocks
    qb, qjb = q.reshape(-1, blk), qj.reshape(-1, blk)
    assert (qb[same] == qjb[same]).all()
    amax = np.abs(flat).max(axis=1)
    recip = np.float32(1.0) / np.float32(127.0)
    moved = ~same
    assert (s[moved] == amax[moved] / np.float32(127.0)).all()
    assert (sj[moved] == amax[moved] * recip).all()
    want = np.clip(np.rint(flat[moved] / sj[moved][:, None]), -127, 127)
    assert (qjb[moved] == want.astype(np.int8)).all()
    # K3' multiplies only: bit for bit on the same q and scales
    deq = ref.dequantize_int8_ref(torch.from_numpy(q), torch.from_numpy(s),
                                  block)
    deq_j = jops.dequantize_int8(jnp.asarray(q), jnp.asarray(s), block=block)
    assert _bits(deq) == np.asarray(deq_j).tobytes()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_against_interpreted_pallas(shape, block, dtype):
    x = _normal(shape, seed=len(shape) + block)
    xj, xt = _both(x, dtype)
    _assert_equal_to_pallas(x, xj, xt, block)


@pytest.mark.parametrize("name,x,block",
                         [s for s in SPECIAL if s[0] != "empty"],
                         ids=[s[0] for s in SPECIAL if s[0] != "empty"])
def test_plain_against_interpreted_pallas_special(name, x, block):
    xj, xt = _both(x, "float32")
    _assert_equal_to_pallas(x, xj, xt, block)


def test_the_reciprocal_rewrite_shows():
    """Bf16 inputs of (1000, 37) at block 64: the interpreted Pallas
    kernel's scale departs from the division on some blocks, and the
    reference package's own ref and ops disagree there (C7)."""
    xj, _ = _both(_normal((1000, 37), seed=0), "bfloat16")
    _, sj = jops.quantize_int8(xj, block=64)
    _, sr = jref.quantize_int8_ref(xj, block=64)
    assert int(jnp.sum(sj != sr)) > 0


# the CNN's leaf shapes at block = n, and test_kernels' (1000, 37)
LEAVES = [(3136, 2048), (5, 5, 32, 64), (62,), (1000, 37), (5, 5, 1, 32)]


@pytest.mark.parametrize("shape", LEAVES)
def test_block_n_is_the_fl_per_tensor_quantiser(shape):
    x = _normal(shape, seed=11, scale=1e-3)
    q, s = ref.quantize_int8_ref(torch.from_numpy(x), block=x.size)
    qj, sj = jcomp.quantize_int8(jnp.asarray(x))
    assert q.numpy().tobytes() == np.asarray(qj).reshape(-1).tobytes()
    assert s.numpy().tobytes() == np.asarray(sj).reshape(1).tobytes()
    # and the port's fl.compression, which calls the dispatch at block = n
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.shape == x.shape and ts.shape == ()
    assert _bits(tq) == np.asarray(qj).tobytes()
    assert _bits(tcomp.dequantize_int8(tq, ts)) == np.asarray(
        jcomp.dequantize_int8(qj, sj)).tobytes()


def _near_ties(seed: int) -> np.ndarray:
    """Blocks of 256 whose x / scale lies within a few ulps of k + 1/2:
    each block's scale from a random amax, the rest (k + 1/2)·scale
    nudged by up to 8 ulps either way."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(64):
        amax = np.float32(10.0 ** rng.uniform(-20, 20))
        scale = amax / np.float32(127)
        k = rng.integers(-127, 127, 255).astype(np.float32) + np.float32(0.5)
        x = (k * scale).astype(np.float32)
        x = x + (rng.integers(-8, 9, 255) * np.spacing(x)).astype(np.float32)
        out.append(np.concatenate([[amax], np.clip(x, -amax, amax)]))
    return np.concatenate(out).astype(np.float32)


def _ieee_q(x: np.ndarray, block: int):
    """(q, scales) by the definition, in numpy float32: IEEE division by
    the scale, rint half to even, clamp."""
    n = x.size
    blocks = np.pad(x.reshape(-1), (0, -(-n // block) * block - n)).reshape(
        -1, block)
    amax = np.abs(blocks).max(axis=1)
    scale = np.where(amax > 0, amax / np.float32(127), np.float32(1))
    q = np.clip(np.rint(blocks / scale[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scale.astype(np.float32)


# (name, x, block): quotients a multiply by 1 / scale would round apart
# from the division, at scales from subnormal to 1e30
HARD_QUOTIENTS = [
    ("normal", _normal(100_000, seed=11), 100_000),
    ("normal_blocks", _normal(100_000, seed=12), 5000),
    ("large", _normal(20_000, seed=13, scale=1e30), 20_000),
    ("tiny", _normal(20_000, seed=14, scale=1e-30), 20_000),
    ("bfloat16", torch.from_numpy(_normal(20_000, seed=15)).bfloat16()
     .float().numpy(), 20_000),
    ("near_ties", _near_ties(16), 256),
    ("ties", _ties(), 8),
    ("subnormal", (_normal(4096, seed=17) * np.float32(1e-39)).astype(
        np.float32), 64),
    ("subnormal_scale", (np.linspace(-1, 1, 4001, dtype=np.float32)
                         * np.float32(127 * 2.0 ** -127)), 4001),
    ("vanishing_scale", np.arange(-200, 200, dtype=np.float32)
     * np.float32(2.0 ** -149), 400),
]


SUBNORMAL = ("subnormal", "vanishing")


@pytest.mark.parametrize("name,x,block", HARD_QUOTIENTS,
                         ids=[d[0] for d in HARD_QUOTIENTS])
def test_plain_divides_on_hard_quotients(name, x, block):
    """The plain K3, which the card's kernels are held to bit for bit,
    against the definition in numpy and the reference's plain K3."""
    q, s = ref.quantize_int8_ref(torch.from_numpy(x), block)
    want_q, want_s = _ieee_q(x, block)
    assert _bits(q) == want_q.tobytes() and _bits(s) == want_s.tobytes()
    if name.startswith(SUBNORMAL):
        return    # XLA on the CPU flushes subnormals to zero
    qj, sj = jref.quantize_int8_ref(jnp.asarray(x), block)
    assert _bits(q) == np.asarray(qj).tobytes()
    assert _bits(s) == np.asarray(sj).tobytes()


def test_roundtrip_error_bounded_by_half_a_step():
    x = torch.from_numpy(_normal((512, 16), seed=1, scale=3.0))
    rt = ops.roundtrip(x, block=512)
    blocks = x.numpy().reshape(-1, 512)
    steps = np.abs(blocks).max(axis=1) / 127.0
    err = np.abs(rt.numpy() - x.numpy()).reshape(-1, 512)
    assert (err <= steps[:, None] * 0.5 + 1e-6).all()


def test_dispatch_on_cpu_runs_the_plain_version():
    x = torch.from_numpy(_normal((1000, 37), seed=2)).to(torch.bfloat16)
    for block in (64, 4096, 10 ** 9):
        q, s = ops.quantize_int8(x, block)
        qr, sr = ref.quantize_int8_ref(x, block)
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(ops.dequantize_int8(q, s, block),
                           ref.dequantize_int8_ref(q, s, block))
        rt = ops.roundtrip(x, block)
        assert rt.dtype == torch.bfloat16 and rt.shape == x.shape
        assert torch.equal(rt, ref.roundtrip_ref(x, block).bfloat16())
    assert kernel.quantize_launches == 0 and kernel.dequantize_launches == 0
    assert _cuda._lib is None


def test_wrappers_refuse_cpu_tensors_and_bad_blocks():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.quantize_int8_cuda(x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel.quantize_int8_cuda(x.half())
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dequantize_int8_cuda(torch.zeros(8, dtype=torch.int8),
                                    torch.ones(2), 4)
    with pytest.raises(ValueError, match="at least 1"):
        ref.quantize_int8_ref(x, 0)
    assert _cuda._lib is None
