"""The port's single-round API and its sources against ``repro.net``.

* ``simulate_round(backend="reference")``, the cycle-by-cycle simulator
  on its own seeded numpy draws, against the JAX package's on the same
  inputs: every field of ``RoundResult`` bit for bit (both sides are the
  same host float arithmetic), under both policies at loads 0.3 and
  0.8, plain and with ``ul_deadline_s``, ``ul_outage_s``, ``no_dl_ids``
  and ``stream_round``;
* the same simulator fed the engine's counter streams
  (``CounterStream.source``): bit for bit the JAX package's
  counter-sourced run, and within rtol 1e-6 (the engines' contract) of
  the port's engine, ``backend="vectorized"`` and ``"jit"``;
* the Fig. 2b operating point (128 ONUs, 12 clients, load 0.8, fcfs,
  seed 1) through ``simulate_round`` within 1e-9 s of its pins;
* the sources (``PoissonSource``, ``PrecomputedSource``,
  ``per_onu_sources``, ``counter_streams_for_pons``) bit for bit, and
  ``CounterSource`` reading one host copy a materialised chunk;
* the refusals: an unknown backend, ``backend="jit"`` with injected
  sources, injected sources on a multi-PON round, a CUDA device where
  there is none.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.net as J
import repro_torch.net as T
from repro.core.slicing import ClientProfile
from repro.kernels.traffic import ops as jops
from repro.net.traffic import counter_streams_for_pons as j_streams_for_pons
from repro_torch.kernels.traffic import ops as tops

CFG = J.PONConfig(n_onus=16, line_rate_bps=1e9)
ENGINE_RTOL = 1e-6
SYNC_ABS = 1e-9
OP_POINT_SYNC = 5.058100000000024        # the engine's (chip_smoke.SYNC_TABLE)
OP_POINT_REF_SYNC = 5.029100000000014    # the reference's own draws
IDS = [0, 1, 3, 5, 17, 19, 21]           # clients 17, 19, 21 share ONUs
VARIANTS = {
    "plain": {},
    "deadline": {"ul_deadline_s": 0.3},
    # a bs slot inside the window is lost, and its client is served
    # no more: the deadline ends the round
    "outage": {"ul_outage_s": (0.05, 0.2), "ul_deadline_s": 1.0},
    "no_dl": {"no_dl_ids": frozenset({1, 17})},
    "stream_round": {"stream_round": 3},
}


def _clients(ids, seed=0, m_lo=1e5, m_hi=1e6):
    rng = np.random.default_rng(seed)
    return [ClientProfile(client_id=int(i),
                          t_ud=float(rng.uniform(0.05, 0.5)), t_dl=0.0,
                          m_ud_bits=float(rng.uniform(m_lo, m_hi)))
            for i in ids]


def _workload(policy, seed=0):
    ids = [i for i in IDS if i < CFG.n_onus] if policy == "bs" else IDS
    return J.FLRoundWorkload(clients=_clients(ids, seed), model_bits=4e5)


def _same_times(a: dict, b: dict, what: str, rtol: float = 0.0):
    assert list(b) == list(a), what
    for cid, x in a.items():
        y = b[cid]
        if np.isnan(x):
            assert np.isnan(y), (what, cid)
        elif rtol:
            assert y == pytest.approx(x, rel=rtol, abs=1e-12), (what, cid)
        else:
            assert y == x, (what, cid, x, y)


def same_result(a, b, rtol: float = 0.0):
    """Every field of two ``RoundResult``s; bit for bit unless ``rtol``
    (then the key order of the per-client maps is not held either)."""
    assert b.policy == a.policy and b.load == a.load
    for name in ("dl_done", "ready", "ul_done"):
        da, db = getattr(a, name), getattr(b, name)
        if rtol:
            da, db = dict(sorted(da.items())), dict(sorted(db.items()))
        _same_times(da, db, name, rtol)
    for name in ("sync_time", "compute_bound", "comm_overhead"):
        x, y = getattr(a, name), getattr(b, name)
        assert (y == pytest.approx(x, rel=rtol) if rtol else y == x), name
    if a.ul_remaining is None:
        assert b.ul_remaining is None
    else:
        ra, rb = a.ul_remaining, b.ul_remaining
        if rtol:
            ra, rb = dict(sorted(ra.items())), dict(sorted(rb.items()))
        _same_times(ra, rb, "ul_remaining", rtol)
    if a.slice_spec is None:
        assert b.slice_spec is None
    else:
        sa = dataclasses.asdict(a.slice_spec)
        sb = dataclasses.asdict(b.slice_spec)
        if rtol:
            assert sb == pytest.approx(sa, rel=rtol)
        else:
            assert sb == sa
    if a.job_stats is None:
        assert b.job_stats is None


# -- the reference backend on its own draws -----------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("load", [0.3, 0.8])
@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_reference_matches_jax(policy, load, variant):
    wl = _workload(policy)
    kw = VARIANTS[variant]
    want = J.simulate_round(CFG, wl, load, policy, seed=3,
                            backend="reference", **kw)
    got = T.simulate_round(T.from_reference(CFG), T.from_reference(wl),
                           load, policy, seed=3, backend="reference",
                           device="cpu", **kw)
    same_result(want, got)
    if variant == "deadline":
        assert got.ul_remaining        # the deadline cuts an upload
    if variant == "no_dl" and policy == "fcfs":
        assert got.dl_done[1] == 0.0 and got.dl_done[17] == 0.0


# -- the reference on the engine's counter streams ----------------------------

def counter_sources(mod, cfg, wl, load, seed, stream_round=0, **kw):
    """Per-ONU counter sources of both phases of ``mod``'s (``J`` or
    ``T``) engine stream for the round, and the streams."""
    topo = mod.MultiPonTopology()
    rate = mod.pon_bg_rates(wl.clients, wl.model_bits, load, cfg, topo)[0]
    ops_ = tops if mod is T else jops
    streams = [mod.CounterStream(ops_.make_stream_key(seed, phase,
                                                      stream_round),
                                 rate, cfg.cycle_time_s, cfg.n_onus,
                                 burst_packets=cfg.bg_burst_packets, **kw)
               for phase in (0, 1)]
    return ([[s.source(i) for i in range(cfg.n_onus)] for s in streams],
            streams)


def _counter_ref(mod, cfg, wl, load, policy, seed, kw, **dev):
    (dl, ul), _ = counter_sources(mod, cfg, wl, load, seed,
                                  kw.get("stream_round", 0), **dev)
    return mod.simulate_round(cfg, wl, load, policy, seed=seed,
                              backend="reference", _dl_sources=dl,
                              _ul_sources=ul, **kw, **dev)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("load", [0.3, 0.8])
@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_counter_reference_matches_jax_and_engines(policy, load, variant):
    wl = _workload(policy, seed=1)
    kw = VARIANTS[variant]
    tcfg, twl = T.from_reference(CFG), T.from_reference(wl)
    got = _counter_ref(T, tcfg, twl, load, policy, 2, kw, device="cpu")
    same_result(_counter_ref(J, CFG, wl, load, policy, 2, kw), got)
    for backend in ("vectorized", "jit"):
        eng = T.simulate_round(tcfg, twl, load, policy, seed=2,
                               backend=backend, device="cpu", **kw)
        same_result(got, eng, ENGINE_RTOL)


@pytest.mark.parametrize("backend", ["vectorized", "jit", "reference",
                                     "counter"])
def test_fig2b_operating_point(backend):
    """12 of 128 ONUs at 10 Gb/s, 26.416 Mbit updates, load 0.8, fcfs,
    seed 1: the engines' pinned sync; the reference on its own draws
    keeps the JAX package's pin (``tests/test_net_engine.py``), and on
    the engine's counter streams it meets the engines' pin."""
    rng = np.random.default_rng(42)
    t_uds = rng.uniform(1.0, 5.0, 128)
    wl = T.FLRoundWorkload(clients=[
        T.from_reference(ClientProfile(client_id=i, t_ud=float(t_uds[i]),
                                       t_dl=0.0, m_ud_bits=26.416e6))
        for i in range(12)], model_bits=26.416e6)
    cfg = T.PONConfig(n_onus=128)
    if backend == "counter":
        res = _counter_ref(T, cfg, wl, 0.8, "fcfs", 1, {}, device="cpu")
    else:
        res = T.simulate_round(cfg, wl, 0.8, "fcfs", seed=1,
                               backend=backend, device="cpu")
    want = OP_POINT_REF_SYNC if backend == "reference" else OP_POINT_SYNC
    assert abs(res.sync_time - want) <= SYNC_ABS, res.sync_time


# -- sources -------------------------------------------------------------------

def test_poisson_and_precomputed_sources():
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    js = J.per_onu_sources(3e9, 8, jr)
    ts = T.per_onu_sources(3e9, 8, tr)
    assert [s.rate_bps for s in ts] == [s.rate_bps for s in js]
    draws = [[s.arrivals(1e-3) for s in src] for src in (js, ts)
             for _ in range(50)]
    assert draws[50:] == draws[:50]
    assert any(sum(row) > 0 for row in draws)
    assert T.PoissonSource(0.0, tr).arrivals(1.0) == 0.0
    rows = np.random.default_rng(1).uniform(0, 1e5, 5)
    jp, tp = J.PrecomputedSource(rows), T.PrecomputedSource(rows)
    assert ([tp.arrivals(1e-3) for _ in range(8)]
            == [jp.arrivals(1e-3) for _ in range(8)])
    assert tp.arrivals(1e-3) == 0.0 and tp.cursor == 9


@pytest.mark.parametrize("chunk", [1024, 100])
def test_counter_source_one_host_copy_a_chunk(chunk):
    n_cycles, n_onus = 2500, 6
    key = tops.make_stream_key(5, 1, 2)
    ts = T.CounterStream(key, 2e7, 1e-3, n_onus, chunk=chunk, device="cpu")
    js = J.CounterStream(jops.make_stream_key(5, 1, 2), 2e7, 1e-3, n_onus,
                         chunk=chunk)
    t_src = [ts.source(i) for i in range(n_onus)]
    j_src = [js.source(i) for i in range(n_onus)]
    got = [[s.arrivals(1e-3) for s in t_src] for _ in range(n_cycles)]
    want = [[s.arrivals(1e-3) for s in j_src] for _ in range(n_cycles)]
    assert got == want
    assert sum(map(sum, got)) > 0
    assert ts.host_copies == -(-n_cycles // chunk)
    # the device rows are the values the host copies hold
    for k in (0, chunk - 1, chunk, n_cycles - 1):
        np.testing.assert_array_equal(ts.rows(k).numpy(), got[k])
    assert ts.host_copies == -(-n_cycles // chunk)


def test_counter_streams_for_pons():
    rates = [1e6, 3e6, 0.0]
    kw = dict(burst_packets=16.0, round_index=4)
    got = T.counter_streams_for_pons(9, 1, rates, 1e-3, 5, device="cpu",
                                     **kw)
    want = j_streams_for_pons(9, 1, rates, 1e-3, 5, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.key, w.key)
        assert g.lam == w.lam
        for k in (0, 700, 1500):
            np.testing.assert_array_equal(g.host_row(k),
                                          np.asarray(w.rows(k)))


# -- refusals ------------------------------------------------------------------

def test_refusals(monkeypatch):
    cfg, wl = T.from_reference(CFG), T.from_reference(_workload("fcfs"))
    with pytest.raises(ValueError, match="unknown backend"):
        T.simulate_round(cfg, wl, 0.5, "fcfs", backend="numpy",
                         device="cpu")
    (dl, ul), _ = counter_sources(T, cfg, wl, 0.5, 0, device="cpu")
    with pytest.raises(ValueError, match="cannot replay injected"):
        T.simulate_round(cfg, wl, 0.5, "fcfs", backend="jit",
                         _dl_sources=dl, _ul_sources=ul, device="cpu")
    with pytest.raises(ValueError, match="single-PON only"):
        T.simulate_round(cfg, wl, 0.5, "fcfs", backend="reference",
                         _dl_sources=dl, _ul_sources=ul, device="cpu",
                         topology=T.MultiPonTopology(n_pons=2))
    with pytest.raises(ValueError, match="one \\(start, end\\) window"):
        T.simulate_round(cfg, wl, 0.5, "fcfs", backend="reference",
                         ul_outage_s=[(0.0, 1.0), (0.0, 1.0)],
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("vectorized", "reference"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.simulate_round(cfg, wl, 0.5, "fcfs", backend=backend)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.simulate_multi_pon_round(cfg, T.MultiPonTopology(n_pons=2), wl,
                                   0.5, "fcfs")
