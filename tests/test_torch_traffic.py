"""The port's counter-based traffic sampler against ``repro``'s.

The plain PyTorch path (``device="cpu"``) must reproduce the JAX
package's ``backend="numpy"`` stream bit for bit: keys, threefry words,
the burst-length table, and the sampled arrival bits, chunked or not.
The Hopper kernel is held to the plain version on a card in
``tests/test_torch_cuda.py``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.kernels.traffic import ops as ref_ops
from repro.net.traffic import CounterStream as RefCounterStream
from repro_torch.kernels.traffic import ops, ref, tables
from repro_torch.net.traffic import CounterStream

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKT = 12_000.0
BURST = 16.0


def _both(keys, cycle0, n_cycles, n_onus, lam):
    want = ref_ops.sample_arrival_bits(keys, cycle0, n_cycles, n_onus, lam,
                                       1 / BURST, PKT, backend="numpy")
    got = ops.sample_arrival_bits(keys, cycle0, n_cycles, n_onus, lam,
                                  1 / BURST, PKT, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    return want, got.numpy()


@pytest.mark.parametrize("seed,phase,rnd,pon,job", [
    (0, 0, 0, 0, 0), (7, 1, 3, 0, 0), (3, 1, 2, 1, 0), (3, 1, 2, 63, 0),
    (2**32 - 1, 1, 5, 2, 1), (11, 0, 0, 0, 4),
])
def test_make_stream_key_equal(seed, phase, rnd, pon, job):
    want = ref_ops.make_stream_key(seed, phase, rnd, pon, job)
    got = ops.make_stream_key(seed, phase, rnd, pon, job)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_threefry_equal():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, (2, 64), dtype=np.uint32)
    c = rng.integers(0, 2**32, (2, 64), dtype=np.uint32)
    want = ref_ops.threefry2x32_np(k[0], k[1], c[0], c[1])
    got = ref.threefry2x32(*(torch.as_tensor(a.astype(np.int64))
                             for a in (k[0], k[1], c[0], c[1])))
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(np.int64), g.numpy())


def test_breakpoint_table_matches_reference_lut():
    spec = importlib.util.spec_from_file_location(
        "gen_burst_table", ROOT / "scripts" / "gen_burst_table.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    starts, lengths = gen.breakpoints(1 / BURST)
    assert tables.burst_table(1 / BURST) == (tuple(starts), tuple(lengths))
    # the runs reproduce the full LUT, including input 2953216 (F1)
    lut = np.asarray(ref_ops._geometric_lut(1 / BURST))
    u = torch.arange(1 << 24)
    st = torch.tensor(starts)
    got = torch.tensor(lengths)[torch.searchsorted(st, u, right=True) - 1]
    assert np.array_equal(got.numpy(), lut)


@pytest.mark.parametrize("cycle0,n_cycles,n_onus", [
    (0, 64, 8), (5, 64, 21), (77, 130, 2), (1000, 200, 37), (63, 65, 1),
])
def test_sampler_bitwise_parity_shapes(cycle0, n_cycles, n_onus):
    key = ref_ops.make_stream_key(seed=5, phase=0, round_index=1)
    want, got = _both(key, cycle0, n_cycles, n_onus, 0.6)
    assert np.array_equal(want, got)


def test_sampler_bitwise_mixed_rates():
    keys = np.stack([
        ref_ops.make_stream_key(s, p, r)
        for s in (0, 3) for p in (0, 1) for r in (0, 2)
    ])
    lams = np.linspace(0.05, 3.0, len(keys)).astype(np.float32)
    lams[2] = 0.0
    want, got = _both(keys, 900, 150, 19, lams)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("pon,total,head", [
    (0, 209_160_000.0, [36000.0, 0.0, 0.0, 0.0, 0.0, 408000.0, 0.0]),
    (1, 193_656_000.0, [72000.0, 0.0, 24000.0, 0.0, 0.0, 0.0, 0.0]),
])
def test_stream_fingerprints(pon, total, head):
    key = ops.make_stream_key(seed=3, phase=1, round_index=2, pon=pon)
    got = ops.sample_arrival_bits(key, 128, 256, 8, 0.5, 1 / BURST, PKT,
                                  device="cpu")
    assert float(got.sum()) == total
    assert got[0, :7, 0].tolist() == head


def test_chunk_invariance():
    key = ops.make_stream_key(seed=7, phase=1, round_index=3)

    def sample(k, n):
        return ops.sample_arrival_bits(key, k, n, 16, 0.4, 1 / BURST, PKT,
                                       device="cpu")

    full = sample(0, 300)
    for splits in ([1, 299], [37, 90, 173], [64, 64, 64, 108]):
        parts, k = [], 0
        for n in splits:
            parts.append(sample(k, n))
            k += n
        assert torch.equal(full, torch.cat(parts, dim=1)), splits


def test_seek_matches_prefix():
    key = ops.make_stream_key(seed=11, phase=0)
    full = ops.sample_arrival_bits(key, 0, 512, 8, 0.7, 1 / BURST, PKT,
                                   device="cpu")
    window = ops.sample_arrival_bits(key, 300, 100, 8, 0.7, 1 / BURST, PKT,
                                     device="cpu")
    assert torch.equal(full[:, 300:400, :], window)


def test_counter_stream_rows_equal():
    key = ops.make_stream_key(4, 1, 0, 1)
    a = RefCounterStream(key, 4e8, 1e-3, 6, chunk=100)
    b = CounterStream(key, 4e8, 1e-3, 6, chunk=100, device="cpu")
    for k in (0, 57, 99, 100, 250, 180):
        assert np.array_equal(a.rows(k), b.rows(k).numpy())


@pytest.mark.parametrize("inv_burst", [0.4, 0.5, 1 / 8])
def test_unknown_inv_burst_raises(inv_burst):
    with pytest.raises(ValueError, match="inv_burst"):
        ops.sample_arrival_bits(ops.make_stream_key(0, 0), 0, 64, 4, 0.3,
                                inv_burst, PKT, device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.sample_arrival_bits(ops.make_stream_key(0, 0), 0, 64, 4, 0.3,
                                1 / BURST, PKT)
