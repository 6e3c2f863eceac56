"""The port's SSD scans and causal conv against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and handed to both packages.

* ``ssd_scan_ref`` (the token recurrence) and ``ssd_chunked_ref`` (the
  chunked algorithm, the plain version of the kernel K5) against the
  reference's token recurrence and its Pallas kernel ``ssd_scan_fwd``
  run in interpret mode, on the shapes of ``tests/test_kernels.py``:
  within 1e-4 of the largest value, that file's measure.
* ``ssd_chunked_ref``'s y and final state against the reference model's
  ``ssd_chunked``, with and without an initial state and on ragged
  lengths, at chunk sizes where the reference's product form is finite:
  within 2e-5 (the same float32 arithmetic summed in another order).
* C5: at chunk 128 with in-chunk sums of dt |a| past 89 the reference
  model's ``ssd_chunked`` returns NaN (``exp`` of the positive upper
  triangle overflows, times a zero mask); the port masks the exponent
  before ``exp`` and stays finite and right.
* The tensor-core K5's precision plan, where no card is present: a
  plain emulation of its three phases (chunk states, the scan over
  them, chunk outputs), each fp32 operand of a product passed as a hi +
  lo bf16 pair, stays within 1e-4 of the reference model's
  ``ssd_chunked`` and of the Pallas kernel; one bf16 rounding of the
  same operands does not.
* ``kernel.route`` on the kernel-test and card-test shapes.
* ``causal_conv1d`` with and without a conv state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_scan_fwd
from repro.kernels.ssd.ref import ssd_scan_ref as jax_scan_ref
from repro.models import rglru as jrglru
from repro.models.ssd import ssd_chunked as jax_chunked
from repro_torch import _cuda
from repro_torch.kernels.ssd import kernel, ops, ref
from repro_torch.models import rglru as trglru

TOL = dict(atol=2e-5, rtol=2e-5)
REL = 1e-4


def _inputs(B, S, H, P, N, seed=0, dt_shift=0.0, h0=False):
    """x, B, C, dt (post-softplus), a, h0 as float32 numpy arrays, as
    ``tests/test_kernels.py`` draws them (B and C scaled by 0.3)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    bm = rng.standard_normal((B, S, N), np.float32) * 0.3
    cm = rng.standard_normal((B, S, N), np.float32) * 0.3
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), np.float32)
                         + dt_shift)).astype(np.float32)
    a = -np.exp(rng.standard_normal(H, np.float32) * 0.2).astype(np.float32)
    h = rng.standard_normal((B, H, P, N), np.float32) if h0 else None
    return x, bm, cm, dt, a, h


def _torch(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-9)


# the shapes of tests/test_kernels.py::TestSSD (B, S, H, P, N, chunk)
KERNEL_SHAPES = [(2, 120, 3, 16, 32, 128), (1, 256, 2, 64, 64, 64),
                 (1, 33, 1, 8, 16, 8)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", KERNEL_SHAPES)
def test_plain_scans_match_jax_ref_and_pallas_kernel(B, S, H, P, N, chunk):
    arrays = _inputs(B, S, H, P, N, seed=S)
    want_ref = np.asarray(jax_scan_ref(*_jax(arrays[:5])))
    want_kernel = np.asarray(ssd_scan_fwd(*_jax(arrays[:5]), chunk=chunk,
                                          interpret=True))
    y_seq, _ = ref.ssd_scan_ref(*_torch(arrays[:5]))
    y_chunk, _ = ref.ssd_chunked_ref(*_torch(arrays[:5]), chunk)
    for got in (y_seq, y_chunk):
        assert _rel_err(got.numpy(), want_ref) < REL
        assert _rel_err(got.numpy(), want_kernel) < REL


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S,chunk", [(64, 16), (61, 16), (29, 8), (5, 8),
                                     (100, 32)])
def test_chunked_ref_matches_jax_chunked(S, chunk, h0):
    arrays = _inputs(2, S, 3, 16, 24, seed=S + chunk, h0=h0)
    want_y, want_h = jax_chunked(*_jax(arrays[:5]), chunk, _jax(arrays)[5])
    assert np.isfinite(np.asarray(want_y)).all()   # finite at these chunks
    got_y, got_h = ref.ssd_chunked_ref(*_torch(arrays[:5]), chunk,
                                       _torch(arrays)[5])
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("h0", [False, True])
def test_token_recurrence_carries_the_state(h0):
    """``ssd_scan_ref``'s final state and initial state: one scan over S
    equals two scans over the halves, the second from the first's state,
    and equals the chunked version's."""
    arrays = _torch(_inputs(1, 40, 2, 8, 16, seed=7, h0=h0))
    y, h = ref.ssd_scan_ref(*arrays)
    x, bm, cm, dt, a, h0_t = arrays
    y1, h1 = ref.ssd_scan_ref(x[:, :17], bm[:, :17], cm[:, :17], dt[:, :17],
                              a, h0_t)
    y2, h2 = ref.ssd_scan_ref(x[:, 17:], bm[:, 17:], cm[:, 17:], dt[:, 17:],
                              a, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(h2, h, **TOL)
    y_c, h_c = ref.ssd_chunked_ref(*arrays[:5], 16, h0_t)
    torch.testing.assert_close(y_c, y, **TOL)
    torch.testing.assert_close(h_c, h, **TOL)


def test_c5_reference_product_form_overflows_port_stays_right():
    """At chunk 128 the reference model's ``ssd_chunked`` forms
    ``exp(cum_t - cum_s) * tril``: the upper triangle's exponent passes
    88.7 and ``inf * 0`` gives NaN. The port's plain version masks the
    exponent first (as the Pallas kernel does) and equals the token
    recurrence."""
    arrays = _inputs(1, 256, 2, 16, 32, seed=3, dt_shift=1.5)
    dt, a = arrays[3], arrays[4]
    chunk_sums = (dt * -a).reshape(1, 2, 128, 2).sum(axis=2)
    assert chunk_sums.max() > 89.0
    want_y, _ = jax_chunked(*_jax(arrays[:5]), 128)
    assert np.isnan(np.asarray(want_y)).any()
    got_y, got_h = ref.ssd_chunked_ref(*_torch(arrays[:5]), 128)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    want = np.asarray(jax_scan_ref(*_jax(arrays[:5])))
    assert _rel_err(got_y.numpy(), want) < REL
    assert _rel_err(got_y.numpy(), np.asarray(ssd_scan_fwd(
        *_jax(arrays[:5]), chunk=128, interpret=True))) < REL
    _, h_seq = ref.ssd_scan_ref(*_torch(arrays[:5]))
    assert _rel_err(got_h.numpy(), h_seq.numpy()) < REL


def test_ops_on_cpu_takes_the_chunked_plain_version():
    arrays = _torch(_inputs(2, 45, 3, 16, 16, seed=11, h0=True))
    before = kernel.launches
    y, h = ops.ssd_scan(*arrays[:5], 8, arrays[5])
    want_y, want_h = ref.ssd_chunked_ref(*arrays[:5], 8, arrays[5])
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert kernel.launches == before
    assert _cuda._lib is None


def test_ops_on_cpu_keeps_gradients():
    x, bm, cm, dt, a, _ = _torch(_inputs(1, 20, 2, 8, 8, seed=12))
    x.requires_grad_()
    y, _ = ops.ssd_scan(x, bm, cm, dt, a, 8)
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    arrays = _torch(_inputs(1, 16, 2, 8, 16, seed=13))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_scan_cuda(*arrays[:5], 8)
    assert kernel.launches == before
    assert _cuda._lib is None


def test_ssd_source_is_built():
    assert "ssd_scan.cu" in _cuda.SOURCES
    assert (_cuda.CSRC / "ssd_scan.cu").exists()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv1d_matches_jax(S, with_state):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12), np.float32)
    w = rng.standard_normal((4, 12), np.float32)
    state = rng.standard_normal((2, 3, 12), np.float32) if with_state else None
    want_y, want_state = jrglru.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    got_y, got_state = trglru.causal_conv1d(
        torch.as_tensor(x), torch.as_tensor(w),
        None if state is None else torch.as_tensor(state))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _operand(v: torch.Tensor, split: bool) -> list:
    """``v`` as the tensor cores get it: ``[hi, lo]`` with hi = bf16(v)
    and lo = bf16(v - hi), or ``[bf16(v)]``."""
    hi = _bf16(v)
    return [hi, _bf16(v - hi)] if split else [hi]


def _tc_emulation(x, bm, cm, dt, a, chunk, h0=None, split=True):
    """The tensor-core K5's arithmetic in plain float32: x, B and C are
    bf16 values (exact operands); ``x w``, the scores and the state that
    enters a chunk are rounded as the kernel rounds them; products sum
    in float32."""
    Bsz, S, H, P = x.shape
    N = bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xf = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    bf = torch.nn.functional.pad(bm, (0, 0, 0, pad))
    cf = torch.nn.functional.pad(cm, (0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    xf = xf.reshape(Bsz, nc, chunk, H, P)
    bf = bf.reshape(Bsz, nc, chunk, N)
    cf = cf.reshape(Bsz, nc, chunk, N)
    dtf = dtf.reshape(Bsz, nc, chunk, H)
    cum = torch.cumsum(dtf * a, dim=2)                     # (B, nc, Q, H)
    seg = cum[:, :, -1]                                    # (B, nc, H)

    # 1. chunk states: (x w)^T . B, x w = x exp(seg - cum) dt split
    w = torch.exp(seg[:, :, None] - cum) * dtf
    states = sum(torch.einsum("bcshp,bcsn->bchpn", xw, bf)
                 for xw in _operand(xf * w[..., None], split))
    # 2. the scan over chunk states, in float32
    h = torch.zeros((Bsz, H, P, N)) if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(seg[:, c])[..., None, None] * h + states[:, c]
    h_in = torch.stack(h_in, 1)                            # (B, nc, H, P, N)
    # 3. chunk outputs: scores = (C . B^T) L dt split, h_in split
    cb = torch.einsum("bctn,bcsn->bcts", cf, bf)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, t, s, H)
    L = rel.masked_fill(~tri[None, None, :, :, None], float("-inf")).exp()
    scores = cb[..., None] * L * dtf[:, :, None, :, :]
    y = sum(torch.einsum("bctsh,bcshp->bcthp", sc, xf)
            for sc in _operand(scores, split))
    inter = sum(torch.einsum("bctn,bchpn->bcthp", cf, hh)
                for hh in _operand(h_in, split))
    y = y + torch.exp(cum)[..., None] * inter
    return y.reshape(Bsz, nc * chunk, H, P)[:, :S], h


@pytest.mark.parametrize("S,h0", [(512, False), (500, True)])
def test_tensor_core_precision_plan(S, h0):
    """At mamba2's head and state widths (P 64, N 128, chunk 128) with
    bf16 inputs, the split operands keep the tensor-core arithmetic
    within 1e-4 of the reference model's ``ssd_chunked`` (y and final
    state) and of the Pallas kernel (y); one bf16 rounding of the same
    operands misses 1e-4."""
    arrays = list(_inputs(1, S, 4, 64, 128, seed=S, dt_shift=-2.0, h0=h0))
    for i in range(3):                     # x, B, C arrive in bf16
        arrays[i] = _bf16(torch.as_tensor(arrays[i])).numpy()
    x, bm, cm, dt, a, h = _torch(arrays)
    want_y, want_h = jax_chunked(*_jax(arrays[:5]), 128, _jax(arrays)[5])
    want_kernel = ssd_scan_fwd(*_jax(arrays[:5]), chunk=128, interpret=True)
    got_y, got_h = _tc_emulation(x, bm, cm, dt, a, 128, h)
    assert _rel_err(got_y.numpy(), want_y) < REL
    assert _rel_err(got_h.numpy(), want_h) < REL
    if not h0:                             # the Pallas kernel starts at 0
        assert _rel_err(got_y.numpy(), want_kernel) < REL
    one_y, one_h = _tc_emulation(x, bm, cm, dt, a, 128, h, split=False)
    assert max(_rel_err(one_y.numpy(), want_y),
               _rel_err(one_h.numpy(), want_h)) > REL


def _strided(B, S, H, P, N, dtype, strided):
    """x, B, C as the model passes them (slices of one xBC tensor) or
    contiguous, for the route's stride test."""
    xbc = torch.zeros((B, S, H * P + 2 * N), dtype=dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    if not strided:
        x, bm, cm = x.contiguous(), bm.contiguous(), cm.contiguous()
    return x, bm, cm


# kernel-test and card-test shapes (B, S, H, P, N, chunk) and the route a
# bf16 input takes there: P 64, N 64 or 128, chunk 64 or 128
ROUTE_SHAPES = [
    ((2, 120, 3, 16, 32, 128), "cuda_cores"),       # P 16
    ((1, 256, 2, 64, 64, 64), "tensor_cores"),
    ((1, 33, 1, 8, 16, 8), "cuda_cores"),
    ((2, 2000, 2, 64, 128, 128), "tensor_cores"),
    ((1, 512, 3, 16, 16, 8), "cuda_cores"),
    ((1, 300, 2, 72, 200, 128), "cuda_cores"),      # P 72, N 200
    ((4, 2048, 48, 64, 128, 128), "tensor_cores"),  # mamba2-780m prefill
    ((1, 100, 2, 64, 128, 128), "tensor_cores"),    # S below one chunk
    ((1, 300, 2, 64, 256, 128), "cuda_cores"),      # N 256
    ((1, 300, 2, 64, 128, 32), "cuda_cores"),       # chunk 32
]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("shape,want", ROUTE_SHAPES)
def test_route_table(shape, want, strided):
    B, S, H, P, N, chunk = shape
    x, bm, cm = _strided(B, S, H, P, N, torch.bfloat16, strided)
    strides = kernel.tma_strides(x, bm, cm)
    assert kernel.route(torch.bfloat16, P, N, chunk, strides) == want
    # float32 always stays on the CUDA cores
    x, bm, cm = _strided(B, S, H, P, N, torch.float32, strided)
    assert kernel.route(torch.float32, P, N, chunk,
                        kernel.tma_strides(x, bm, cm)) == "cuda_cores"


def test_route_needs_16_byte_strides():
    """A position stride of 8 bytes past a 16-byte multiple (x sliced out
    of a row of H * P + 4 elements), or a misaligned B, goes to the CUDA
    cores."""
    xbc = torch.zeros((2, 128, 2 * 64 + 2 * 128 + 4), dtype=torch.bfloat16)
    x = xbc[..., :128].reshape(2, 128, 2, 64)
    bm, cm = xbc[..., 128:256], xbc[..., 256:384]
    assert kernel.route(torch.bfloat16, 64, 128, 128,
                        kernel.tma_strides(x, bm, cm)) == "cuda_cores"
    xbc = torch.zeros((2, 128, 2 * 64 + 2 * 128 + 8), dtype=torch.bfloat16)
    x = xbc[..., :128].reshape(2, 128, 2, 64)
    assert kernel.route(torch.bfloat16, 64, 128, 128, kernel.tma_strides(
        x, xbc[..., 128:256], xbc[..., 256:384])) == "tensor_cores"
    assert kernel.route(torch.bfloat16, 64, 128, 128, kernel.tma_strides(
        x, xbc[..., 132:260], xbc[..., 260:388])) == "cuda_cores"


def test_tensor_core_source_is_built():
    assert "ssd_scan_tc.cu" in _cuda.SOURCES
    assert (_cuda.CSRC / "ssd_scan_tc.cu").exists()
    assert (_cuda.CSRC / "hopper.cuh").exists()


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """An edited header names another library, so nothing stale loads."""
    for path in list(_cuda.CSRC.glob("*.cu")) + list(_cuda.CSRC.glob("*.cuh")):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = _cuda.library_path()
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _cuda.library_path() != before

