"""K1's launch plan (``kernels/traffic/kernel.py::_launch_plan``).

The CUDA kernel cuts a call into tiles (one case, whole 64-cycle
windows, an ONU span) planned on the host. These tests hold, without a
card, that the tiles cover every output element exactly once at any
``cycle0`` alignment, that each tile holds whole windows (a burst lands
in its own window, so in its own tile), that the plan refuses no shape
the kernel took before its redesign, and that the kernel's algorithm
over the plan (draw 0, an exclusive scan numbering the tile's bursts,
burst ``n`` mapped to its cell by a search on the scan, integer sums,
one float64 write) gives the plain version's bits. The kernel itself is
held to the plain version on a card in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch._device import MASK32
from repro_torch.kernels.traffic import kernel, ops, ref, tables

N_BP = len(ops._table(1 / 16, torch.device("cpu"))[0])
PKT = 12_000.0
# what the kernel took before its redesign: its tables in the default
# 48 KB of shared memory, the batch on grid y
_OLD_SMEM = 48 * 1024
_OLD_MAX_B = 65535
_OLD_MAX_DRAWS = _OLD_SMEM // 4 - 2 * N_BP
_CARD_BYTES = 80e9


def _coverage(plan):
    """How many tiles write each output element; checks each tile on the
    way: a non-empty region of whole windows, at most THREADS cells."""
    hits = np.zeros((plan.B, plan.n_cycles, plan.n_onus), np.int32)
    for t in range(plan.n_tiles):
        b, (c_lo, c_hi), (o_lo, o_hi) = plan.region(t)
        assert 0 <= b < plan.B
        assert 0 <= c_lo < c_hi <= plan.n_cycles
        assert 0 <= o_lo < o_hi <= plan.n_onus
        assert c_lo == 0 or (c_lo + plan.lo) % ref.WINDOW == 0
        assert c_hi == plan.n_cycles or (c_hi + plan.lo) % ref.WINDOW == 0
        n_w = -(-(c_hi + plan.lo) // ref.WINDOW) - (c_lo + plan.lo) \
            // ref.WINDOW
        assert n_w <= plan.wpt
        assert n_w * (o_hi - o_lo) <= kernel.THREADS
        hits[b, c_lo:c_hi, o_lo:o_hi] += 1
    return hits


def _check_plan(B, cycle0, n_cycles, n_onus, n_draws=88):
    plan = kernel._launch_plan(B, cycle0, n_cycles, n_onus, n_draws, N_BP)
    assert (plan.B, plan.n_cycles, plan.n_onus) == (B, n_cycles, n_onus)
    assert (plan.win0, plan.n_win, plan.lo) == ref._windows(cycle0, n_cycles)
    assert plan.n_tiles == B * plan.n_spans * plan.n_wtiles
    assert plan.wpt * plan.span <= kernel.THREADS
    assert plan.smem_bytes == 4 * (plan.wpt * ref.WINDOW * plan.span
                                   + n_draws + 2 * N_BP
                                   + 2 * kernel.THREADS
                                   + kernel.THREADS // 32)
    assert plan.smem_bytes <= kernel.SMEM_LIMIT
    assert np.all(_coverage(plan) == 1)
    return plan


@pytest.mark.parametrize("n_cycles", [1, 2, 63, 64, 65, 130, 1024])
@pytest.mark.parametrize("cycle0", [0, 1, 63, 64, 65, 127, 5120, 5121])
def test_tiles_cover_the_output_once(cycle0, n_cycles):
    for B, n_onus in ((1, 1), (8, 128), (3, 129), (1, 2048), (16, 74)):
        _check_plan(B, cycle0, n_cycles, n_onus)


@settings(max_examples=60, deadline=None)
@given(B=st.integers(1, 4), cycle0=st.integers(0, 2**20),
       n_cycles=st.integers(1, 700), n_onus=st.integers(1, 300),
       n_draws=st.integers(1, 2000))
def test_tiles_cover_the_output_once_any_alignment(B, cycle0, n_cycles,
                                                   n_onus, n_draws):
    _check_plan(B, cycle0, n_cycles, n_onus, n_draws)


@pytest.mark.parametrize("B,n_cycles,n_onus", [
    (8, 1024, 128), (1, 1024, 2048), (1, 64, 8), (16, 4096, 74),
])
def test_main_path_shapes_fill_the_card(B, n_cycles, n_onus):
    """The engine's chunks give at least one CTA each of the H100's 132
    streaming multiprocessors; the span stays whole warps of doubles."""
    plan = _check_plan(B, 0, n_cycles, n_onus)
    if B * n_cycles * n_onus >= 1 << 20:
        assert plan.n_tiles >= 132
        assert plan.span >= kernel._MIN_SPAN


def test_the_old_limits_in_numbers():
    assert 4 * (_OLD_MAX_DRAWS + 2 * N_BP) <= _OLD_SMEM
    assert 4 * (_OLD_MAX_DRAWS + 1 + 2 * N_BP) > _OLD_SMEM


@pytest.mark.parametrize("n_draws", [1, 88, 543, 4000, _OLD_MAX_DRAWS])
@pytest.mark.parametrize("B", [1, 8, _OLD_MAX_B])
def test_plan_refuses_nothing_the_old_kernel_took(B, n_draws):
    for n_onus in (1, 127, 128, 129, 2048, 20_000):
        for n_cycles in (1, 63, 64, 1024, 65_536):
            if B * n_cycles * n_onus * 8 > _CARD_BYTES:
                continue        # no such output fits on the card
            for cycle0 in (0, 63, 10**6 + 1):
                plan = kernel._launch_plan(B, cycle0, n_cycles, n_onus,
                                           n_draws, N_BP)
                assert plan.smem_bytes <= kernel.SMEM_LIMIT
                assert plan.n_tiles <= kernel._GRID_LIMIT


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, _OLD_MAX_B), cycle0=st.integers(0, 2**40),
       n_cycles=st.integers(1, 1 << 20), n_onus=st.integers(1, 1 << 16),
       n_draws=st.integers(1, _OLD_MAX_DRAWS))
def test_plan_refuses_nothing_the_old_kernel_took_any(B, cycle0, n_cycles,
                                                      n_onus, n_draws):
    if B * n_cycles * n_onus * 8 <= _CARD_BYTES:
        kernel._launch_plan(B, cycle0, n_cycles, n_onus, n_draws, N_BP)


def test_plan_refuses_past_shared_memory():
    n_draws = kernel.SMEM_LIMIT // 4
    with pytest.raises(ValueError, match="shared memory"):
        kernel._launch_plan(1, 0, 64, 128, n_draws, N_BP)


def _tiled(keys, cycle0, thresholds, starts, lengths, packet_bits, *,
           n_cycles, n_onus):
    """The kernel's algorithm over its plan, in numpy: per tile, draw 0
    a cell, an exclusive scan of the counts, burst ``n`` to the last
    cell whose first burst number is ``<= n``, its draw ``j``, integer
    sums on the tile's rows, the rows inside the call written once."""
    B = keys.shape[0]
    n_draws = thresholds.shape[1]
    plan = kernel._launch_plan(B, cycle0, n_cycles, n_onus, n_draws,
                               len(starts))
    count = ref.window_counts(keys, cycle0, n_cycles, n_onus,
                              thresholds).numpy()
    st_np, ln_np = starts.numpy(), lengths.numpy()
    out = np.full((B, n_cycles, n_onus), np.nan)
    for t in range(plan.n_tiles):
        b, (c_lo, c_hi), (o_lo, o_hi) = plan.region(t)
        w_lo = (c_lo + plan.lo) // ref.WINDOW
        w_hi = -(-(c_hi + plan.lo) // ref.WINDOW)
        width = o_hi - o_lo
        cells = count[b, w_lo:w_hi, o_lo:o_hi].reshape(-1)
        first = np.concatenate([[0], np.cumsum(cells)[:-1]])
        n = np.arange(int(cells.sum()))
        cell = np.searchsorted(first, n, side="right") - 1
        j = n - first[cell] + 1
        wl, o = cell // width, cell % width
        k0, k1 = (keys[b, i].item() for i in (0, 1))
        kd0, kd1 = ref.draw_key(k0, k1, torch.as_tensor(j))
        x0, x1 = ref.threefry2x32(
            kd0, kd1, torch.as_tensor((plan.win0 + w_lo + wl) & MASK32),
            torch.as_tensor(o_lo + o))
        row = wl * ref.WINDOW + (x0 >> 26).numpy()
        glen = ln_np[np.searchsorted(st_np, (x1 >> 8).numpy(),
                                     side="right") - 1]
        tile = np.zeros(((w_hi - w_lo) * ref.WINDOW, width), np.int64)
        np.add.at(tile, (row, o), glen)
        r_base = w_lo * ref.WINDOW - plan.lo
        out[b, c_lo:c_hi, o_lo:o_hi] = (
            tile[c_lo - r_base:c_hi - r_base].astype(np.float64)
            * packet_bits)
    return torch.as_tensor(out)


@pytest.mark.parametrize("cycle0,n_cycles,n_onus,lams", [
    (0, 64, 8, (0.6,)),
    (5, 64, 21, (0.6,)),
    (63, 65, 1, (0.6,)),
    (0, 50, 129, (0.6, 0.2)),
    (100, 150, 37, (0.6,)),
    (7, 40, 2048, (0.3,)),
    (0, 256, 74, (0.0, 5.0, 2.5)),
])
def test_tiled_algorithm_equals_plain_version(cycle0, n_cycles, n_onus,
                                              lams):
    keys = np.stack([ops.make_stream_key(3, 1, r) for r in
                     range(len(lams))])
    lam = np.asarray(lams, np.float32)
    n_draws = ops._tail_bound(float(lam.max()) * ref.WINDOW)
    thr = torch.as_tensor(ref.poisson_thresholds(
        lam.astype(np.float64) * ref.WINDOW, n_draws))
    kt = torch.as_tensor(keys.astype(np.int64))
    starts, lengths = ops._table(1 / 16, torch.device("cpu"))
    args = (kt, cycle0, thr, starts, lengths, PKT)
    kw = dict(n_cycles=n_cycles, n_onus=n_onus)
    want = ref.sample_arrival_bits_ref(*args, **kw)
    assert torch.equal(_tiled(*args, **kw), want)


def test_burst_length_walk_reaches_the_binary_searchs_run():
    """``threefry.cuh::burst_length_walk`` in numpy, at every 24-bit
    input: the float32 guess clamped as the kernel clamps it (log2(0) is
    -inf, NaN goes to 0), then the walk down and up. It ends on the run
    the binary search finds, within two steps of the guess at all but
    the table's dense tail."""
    starts, lengths = (np.asarray(t) for t in tables.burst_table(1 / 16))
    n_bp = len(starts)
    g = np.arange(1 << 24, dtype=np.int32)
    tail = np.float32(1) - (g.astype(np.float32) + np.float32(0.5)) \
        * np.float32(1 / 16777216)
    with np.errstate(divide="ignore", invalid="ignore"):
        guess = np.log2(tail) * np.float32(-10.740053)
    a = np.nan_to_num(np.clip(guess, 0, n_bp - 1), nan=0).astype(np.int32)
    steps = np.zeros_like(a)
    live = np.arange(len(g))
    while live.size:
        ai, gi = a[live], g[live]
        down = (ai > 0) & (starts[ai] > gi)
        up = ~down & (ai + 1 < n_bp) & (starts[np.minimum(ai + 1, n_bp - 1)]
                                         <= gi)
        a[live] = ai - down + up
        steps[live] += down | up
        live = live[down | up]
    want = np.searchsorted(starts, g, side="right") - 1
    assert np.array_equal(a, want)
    assert np.array_equal(lengths[a], lengths[want])
    assert np.mean(steps <= 2) > 0.9999


def test_wrapper_refuses_cpu_tensors():
    keys = torch.zeros((1, 2), dtype=torch.int64)
    thr = torch.zeros((1, 8), dtype=torch.int32)
    starts, lengths = ops._table(1 / 16, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sample_arrival_bits_cuda(keys, 0, thr, starts, lengths, PKT,
                                        n_cycles=64, n_onus=8)
