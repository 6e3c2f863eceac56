"""The port's observability (``repro_torch.obs``) against ``repro.obs``.

Building blocks on seeded numpy inputs: histogram bins against
``np.histogram`` and ``repro.obs`` (random values and values on the
edges), percentiles against the reference histogram's,
``add_block_per_row`` against scattered ``add``, ``merge``/``flat``,
a gauge's block fold against its sequential one; trace save, load and
validation, the disabled tracer, ``MetricsReport`` through JSON and CSV,
``EventLog``.

Reports: the same runs, with a collector, through the JAX package (its
numpy engine) and the port on the CPU (``device="cpu"``, the per-cycle
loop): the Fig. 2b op point under fcfs and bs, a 3-PON CPS round, a
folded timeline, sequential defer/drop/partial rounds at a deadline
that cuts uploads (the op point's deadline scaled to 8 ONUs at 1 Gb/s),
async rounds, faults with quorum, a two-job round and the co-simulation
in its sync and coupled modes. Held exactly: every utilisation, delay
and slack bin, every count, cycle, minimum and maximum, every
percentile, round record, event and span (name and arguments). Held at
rel 1e-12: the sums a phase folds over the cycles of a block (bit
totals, ``grant_utilization``, CPS utilisation, the gauges' and the
utilisation histogram's means), which the port adds with ``torch.sum``
in another order than numpy's. Every run with a collector is bitwise
the same run without one.
"""
import csv
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro.net as J
import repro_torch.net as T
import test_torch_cosim as cosim_tests
from repro import obs as jobs_
from repro.core.slicing import ClientProfile
from repro_torch import obs as tobs
from repro_torch.launch import serve as serve_mod

CFG = J.PONConfig(n_onus=8, line_rate_bps=1e9)
DEADLINE = 0.35
SUM_RTOL = 1e-12
OP_POINT_SYNC = 5.058100000000024
# a phase's sums over cycles (torch.sum's order): held at SUM_RTOL
_CYCLE_SUMS = {"cap_bits", "bg_grant_bits", "fl_grant_bits",
               "residual_bits", "grant_utilization", "cps_want_bits",
               "cps_eff_bits", "cps_utilization", "mean"}
ref_params = cosim_tests.ref_params


# -- building blocks -----------------------------------------------------------

def _values(seed, n=2000):
    """Random values across the delay edges and past both ends, and
    every edge itself."""
    rng = np.random.default_rng(seed)
    edges = tobs.DEFAULT_DELAY_EDGES
    return np.concatenate([rng.uniform(-2.0, 33.0, n), edges,
                           rng.choice(edges, 50)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_bins_equal_numpy_and_reference(seed):
    v = _values(seed)
    edges = tobs.DEFAULT_DELAY_EDGES
    th = tobs.StreamingHistogram(edges, device="cpu")
    jh = jobs_.StreamingHistogram(edges)
    th.add(v)
    jh.add(v)
    counts = th.counts.numpy()
    np.testing.assert_array_equal(counts, jh.counts)
    inside = v[(v >= edges[0]) & (v <= edges[-1])]
    np.testing.assert_array_equal(counts[1:-1],
                                  np.histogram(inside, edges)[0])
    assert counts[0] == np.sum(v < edges[0])
    assert counts[-1] == np.sum(v > edges[-1])
    assert float(th.n) == jh.n and float(th.sum) == float(jh.sum)
    assert float(th.vmin) == float(jh.vmin)
    assert float(th.vmax) == float(jh.vmax)


@pytest.mark.parametrize("seed", [0, 1])
def test_percentiles_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.exponential(4.0, 500), [35.0, -1.0]])
    th = tobs.StreamingHistogram(tobs.DEFAULT_DELAY_EDGES, device="cpu")
    jh = jobs_.StreamingHistogram(tobs.DEFAULT_DELAY_EDGES)
    th.add(v)
    jh.add(v)
    qs = [0.0, 1.0, 25.0, 50.0, 95.0, 99.0, 100.0]
    np.testing.assert_array_equal(th.percentile(qs), jh.percentile(qs))
    assert th.percentile(95.0) == jh.percentile(95.0)
    assert th.summary() == jh.summary()


def test_block_per_row_equals_scattered_add():
    rng = np.random.default_rng(3)
    block = rng.uniform(-0.1, 1.1, (40, 5))
    block[::7] = 1.0                      # the top edge, exactly
    block[3::11] = 0.0
    edges = tobs.DEFAULT_UTIL_EDGES
    a = tobs.StreamingHistogram(edges, (5,), device="cpu")
    b = tobs.StreamingHistogram(edges, (5,), device="cpu")
    j = jobs_.StreamingHistogram(edges, (5,))
    a.add_block_per_row(block)
    j.add_block_per_row(block)
    for row in block:
        b.add(row, rows=np.arange(5))
    np.testing.assert_array_equal(a.counts.numpy(), b.counts.numpy())
    np.testing.assert_array_equal(a.counts.numpy(), j.counts)
    for name in ("n", "vmin", "vmax"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(j, name))
    np.testing.assert_allclose(a.sum.numpy(), j.sum, rtol=SUM_RTOL)
    np.testing.assert_allclose(b.sum.numpy(), j.sum, rtol=SUM_RTOL)
    assert a.summary()["n"] == j.summary()["n"] == 200.0


def test_merge_and_flat():
    rng = np.random.default_rng(4)
    edges = tobs.DEFAULT_DELAY_EDGES
    parts = [rng.uniform(0, 40, 300) for _ in range(3)]
    tm = tobs.StreamingHistogram(edges, device="cpu")
    jm = jobs_.StreamingHistogram(edges)
    for p in parts:
        th = tobs.StreamingHistogram(edges, device="cpu")
        jh = jobs_.StreamingHistogram(edges)
        th.add(p)
        jh.add(p)
        tm.merge(th)
        jm.merge(jh)
    np.testing.assert_array_equal(tm.counts.numpy(), jm.counts)
    assert tm.summary() == jm.summary()
    with pytest.raises(ValueError, match="differing edges"):
        tm.merge(tobs.StreamingHistogram(tobs.DEFAULT_UTIL_EDGES,
                                         device="cpu"))
    rows = rng.integers(0, 4, 500)
    vals = rng.uniform(0, 40, 500)
    tb = tobs.StreamingHistogram(edges, (4,), device="cpu")
    jb = jobs_.StreamingHistogram(edges, (4,))
    tb.add(vals, rows=rows)
    jb.add(vals, rows=rows)
    tf, jf = tb.flat(), jb.flat()
    np.testing.assert_array_equal(tf.counts.numpy(), jf.counts)
    for name in ("n", "sum", "vmin", "vmax"):
        assert float(getattr(tf, name)) == float(getattr(jf, name)), name
    assert tb.summary() == jb.summary()
    np.testing.assert_array_equal(tb.percentile([50.0, 99.0]),
                                  jb.percentile([50.0, 99.0]))


def test_gauge_block_equals_sequential():
    rng = np.random.default_rng(5)
    block = rng.normal(size=(30, 6))
    seq = tobs.GaugeArray(6, device="cpu")
    blk = tobs.GaugeArray(6, device="cpu")
    ref = jobs_.GaugeArray(6)
    for row in block:
        seq.observe(row)
    blk.observe_block(block)
    ref.observe_block(block)
    for g in (seq, blk):
        for name in ("last", "min", "max", "count"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          getattr(ref, name))
        np.testing.assert_allclose(g.sum.numpy(), ref.sum, rtol=SUM_RTOL)
    assert blk.summary()["count"] == 30
    assert tobs.GaugeArray(device="cpu").summary() == {"count": 0}
    c = tobs.CounterArray(3, device="cpu")
    c.add(np.array([1.0, 2.0, 3.5]))
    c.add(torch.ones(3, dtype=torch.float64))
    assert c.total == 9.5


def test_histogram_rejects_bad_edges():
    for edges in ([1.0], [[0.0, 1.0]], [0.0, 1.0, 1.0]):
        with pytest.raises(ValueError, match="edges"):
            tobs.StreamingHistogram(edges, device="cpu")


# -- trace and export ----------------------------------------------------------

def test_trace_round_trip(tmp_path):
    tr = tobs.SpanTracer()
    with tr.span("outer", rows=3):
        with tr.span("inner", tensor=torch.zeros(2)):
            pass
        tr.instant("mark", what="x")
    path = tmp_path / "trace.json"
    tr.save(str(path))
    events = tobs.validate_trace(tobs.load_trace(str(path)))
    assert [e["name"] for e in events] == ["outer", "inner", "mark"]
    outer = events[0]
    assert outer["ph"] == "X" and outer["dur"] >= 0
    assert outer["args"] == {"rows": 3}
    assert isinstance(events[1]["args"]["tensor"], str)   # repr'd


@pytest.mark.parametrize("payload,frag", [
    ({}, "traceEvents"),
    ({"traceEvents": [{"name": "a", "ph": "X"}]}, "missing"),
    ({"traceEvents": [{"name": "a", "ph": "Q", "ts": 0, "dur": 0,
                       "pid": 1, "tid": 1}]}, "unknown trace phase"),
    ({"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": -1,
                       "pid": 1, "tid": 1}]}, "negative"),
])
def test_malformed_traces_are_rejected(payload, frag):
    with pytest.raises(ValueError, match=frag):
        tobs.validate_trace(payload)


def test_disabled_tracer_is_a_noop():
    calls = []
    tr = tobs.SpanTracer(enabled=False,
                         clock=lambda: calls.append(1) or 0.0)
    n = len(calls)
    with tr.span("a"):
        tr.instant("b")
    assert tr.events == [] and len(calls) == n
    assert tobs.NULL_TRACER.enabled is False
    with tobs.maybe_span(None, "x"):
        pass
    col = tobs.Collector(device="cpu")
    with tobs.maybe_span(col, "x"):
        pass
    assert col.tracer.events == []


def test_metrics_report_round_trips(tmp_path):
    col = tobs.Collector(device="cpu")
    col.record_upload_times("fcfs", 0.8, [1.0, 2.0, np.nan, 31.0])
    col.record_slack("bs", 0.3, np.array([0.5, -0.25]))
    col.record_staleness([0, 1, 1])
    col.counter("bits").add(5.0)
    col.gauge("depth", 2).observe(torch.tensor([1.0, 3.0],
                                               dtype=torch.float64))
    st = col.phase("ul:fcfs", 2)
    for c in range(3):
        st.cycle(torch.full((2,), 10.0, dtype=torch.float64),
                 fl_grants=torch.tensor([c * 4.0, 10.0],
                                        dtype=torch.float64))
    col.record_round(round=0, sync_time=1.5)
    col.event("fault.loss", round=0, client=3)
    rep = col.report()
    assert rep.n_events == 1 and rep.counters == {"bits": 5.0}
    assert rep.delay_percentiles["fcfs@load0.8"]["n"] == 3.0
    assert rep.staleness == {"0": 1.0, "1": 2.0}
    ph = rep.phases[0]
    assert ph["cycles"] == 3 and ph["cap_bits"] == 60.0
    assert ph["grant_utilization"] == 42.0 / 60.0
    assert ph["util_hist"]["n"] == 6.0
    path = tmp_path / "summary.json"
    rep.save_json(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(
        rep.to_dict()))
    rep.save_csv(str(tmp_path / "summary.csv"))
    with open(tmp_path / "summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert rows[0]["phase"] == "ul:fcfs" and rows[0]["cycles"] == "3"
    # the JAX package's report of the same records is the same dict
    jcol = jobs_.Collector()
    jcol.record_upload_times("fcfs", 0.8, [1.0, 2.0, np.nan, 31.0])
    jcol.record_slack("bs", 0.3, np.array([0.5, -0.25]))
    jcol.record_staleness([0, 1, 1])
    jcol.counter("bits").add(5.0)
    jcol.gauge("depth", 2).observe(np.array([1.0, 3.0]))
    jst = jcol.phase("ul:fcfs", 2)
    for c in range(3):
        jst.cycle(np.full(2, 10.0), fl_grants=np.array([c * 4.0, 10.0]))
    jcol.record_round(round=0, sync_time=1.5)
    jcol.event("fault.loss", round=0, client=3)
    assert jcol.report().to_dict() == rep.to_dict()


def test_event_log_writes_jsonl_and_echoes(tmp_path, capsys):
    path = tmp_path / "ev.jsonl"
    log = tobs.EventLog(jsonl_path=str(path), clock=lambda: 7.0)
    log.emit("serve", echo="{arch}: {tps:.1f}", arch="a", tps=2.25,
             vec=torch.tensor([1.0, 2.0]), n=np.int64(3))
    log.emit("quiet", x=1)
    log.close()
    assert capsys.readouterr().out == "a: 2.2\n"
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert lines == [{"event": "serve", "ts": 7.0, "arch": "a",
                      "tps": 2.25, "vec": [1.0, 2.0], "n": 3},
                     {"event": "quiet", "ts": 7.0, "x": 1}]


# -- reports held to the reference ----------------------------------------------

def _assert_tree(want, got, path="", in_phase=False):
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            _assert_tree(want[k], got[k], f"{path}/{k}",
                         in_phase or k == "phases")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_tree(a, b, f"{path}[{i}]", in_phase)
    elif (in_phase and isinstance(want, float)
          and path.rsplit("/", 1)[-1] in _CYCLE_SUMS):
        assert got == pytest.approx(want, rel=SUM_RTOL, abs=0.0), path
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


def _same_hist(jh, th, what):
    np.testing.assert_array_equal(th.counts.numpy(), jh.counts,
                                  err_msg=what)
    for name in ("n", "vmin", "vmax"):
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      getattr(jh, name), err_msg=what)


def _assert_collectors(jc, tc):
    """Every bin, count, cycle, extreme, record, event and span exactly;
    the cycle sums at ``SUM_RTOL``."""
    assert [p.label for p in tc.phases] == [p.label for p in jc.phases]
    for jp, tp in zip(jc.phases, tc.phases):
        jp._flush()
        tp._flush()
        assert tp.n_rows == jp.n_rows
        np.testing.assert_array_equal(tp.cycles, jp.cycles)
        _same_hist(jp.util, tp.util, f"{jp.label} util")
        for name in ("bg_backlog", "fl_backlog"):
            jg, tg = getattr(jp, name), getattr(tp, name)
            for f in ("last", "min", "max", "count"):
                np.testing.assert_array_equal(
                    getattr(tg, f).numpy(), getattr(jg, f),
                    err_msg=f"{jp.label} {name} {f}")
    for table in ("delay_hist", "slack_hist"):
        jt, tt = getattr(jc, table), getattr(tc, table)
        assert list(tt) == list(jt), table
        for key in jt:
            _same_hist(jt[key], tt[key], f"{table} {key}")
            assert float(tt[key].sum) == float(jt[key].sum), (table, key)
    assert tc.staleness == jc.staleness
    assert tc.rounds == jc.rounds
    assert tc.events == jc.events
    assert ([(e["name"], e["args"]) for e in tc.tracer.events]
            == [(e["name"], e["args"]) for e in jc.tracer.events])
    _assert_tree(jc.report().to_dict(), tc.report().to_dict())


def _pair_collectors(**kw):
    return (jobs_.Collector(tracer=jobs_.SpanTracer(), **kw),
            tobs.Collector(tracer=tobs.SpanTracer(), device="cpu", **kw))


def _clients(ids, seed=0, m_lo=1e5, m_hi=2e6):
    rng = np.random.default_rng(seed)
    return [ClientProfile(client_id=int(i),
                          t_ud=float(rng.uniform(0.05, 0.6)), t_dl=0.0,
                          m_ud_bits=float(rng.uniform(m_lo, m_hi)))
            for i in ids]


def _cases(policy, loads=(0.6,), seeds=(5,), topology=None):
    # fcfs puts several clients on an ONU; bs needs ids < n_onus * n_pons
    ids = range(6) if policy == "bs" else [0, 1, 5, 9, 17, 19]
    wl = J.FLRoundWorkload(clients=_clients(ids), model_bits=1.5e6)
    return [J.SweepCase(workload=wl, load=load, policy=policy, seed=seed,
                        topology=topology)
            for load, seed in zip(loads, seeds)]


def _op_point_cases():
    rng = np.random.default_rng(42)
    t_uds = rng.uniform(1.0, 5.0, 128)
    wl = J.FLRoundWorkload(clients=[
        ClientProfile(client_id=i, t_ud=float(t_uds[i]), t_dl=0.0,
                      m_ud_bits=26.416e6) for i in range(12)],
        model_bits=26.416e6)
    return [J.SweepCase(workload=wl, load=0.8, policy=p, seed=1)
            for p in ("fcfs", "bs")]


def _jobs_case():
    ids = [0, 1, 2, 3, 9, 10, 11, 12]
    clients = _clients(ids, seed=2, m_lo=5e6, m_hi=2e7)
    jobs = (J.JobSpec(job_id=0, clients=tuple(ids[:4]), model_bits=4e6),
            J.JobSpec(job_id=1, clients=tuple(ids[4:]), model_bits=2e6,
                      weight=2.0))
    wl = J.FLRoundWorkload(clients=clients, model_bits=4e6)
    return [J.SweepCase(workload=wl, load=0.5, policy=p, seed=3,
                        jobs=jobs, fairness="weighted")
            for p in ("fcfs", "bs")]


TOPO3 = J.MultiPonTopology(n_pons=3, cps_rate_bps=2.4e9)
FAULTS = J.FaultSchedule(seed=3, dropout_rate=0.3, loss_rate=0.3)


def _membership(seed, shape, frac):
    memb = np.random.default_rng(seed).random(shape) < frac
    memb[0] = True
    return memb


def _runs():
    """name -> (pon, cases, schedule or None, mode, what the report must
    hold)."""
    op_pon = J.PONConfig(n_onus=128)
    both = _cases("fcfs") + _cases("bs")
    out = {
        "op-point": (op_pon, _op_point_cases(), None, "auto", "phases3"),
        "cps-3pon": (CFG, _cases("fcfs", (0.4,), (5,), TOPO3)
                     + _cases("bs", (0.4,), (5,), TOPO3), None, "auto",
                     "cps"),
        "folded": (CFG, both, J.TimelineSchedule(
            n_rounds=3, membership=_membership(17, (3, 6), 0.7)),
            "folded", "rounds"),
        "async-b6": (CFG, _cases("fcfs", (0.6, 0.8), (3, 4)),
                     J.TimelineSchedule(n_rounds=3, buffer_k=3),
                     "auto", "staleness"),
        "faults-quorum": (CFG, both, J.TimelineSchedule(
            n_rounds=4, deadline_s=0.15, quorum_frac=0.8,
            quorum_max_extends=2, faults=FAULTS,
            retry=J.RetryPolicy(max_retries=1)), "auto", "faults"),
        "two-jobs": (J.PONConfig(n_onus=16, line_rate_bps=1e9),
                     _jobs_case(), None, "auto", "jobs"),
    }
    for dpol in ("defer", "drop", "partial"):
        out[f"sequential-{dpol}"] = (CFG, both, J.TimelineSchedule(
            n_rounds=3, deadline_s=DEADLINE, deadline_policy=dpol),
            "sequential", "slack")
    return out


RUNS = _runs()


def _port_spec(pon, cases, sched, mode, backend=None):
    return T.SweepSpec(cases=tuple(T.from_reference(list(cases))),
                       pon=T.from_reference(pon),
                       schedule=None if sched is None else
                       T.from_reference(sched),
                       mode=mode, backend=backend)


def _held(name, jc, results):
    """What each run is there to show did happen."""
    what = RUNS[name][4]
    rep = jc.report()
    if what == "phases3":
        assert [p["label"] for p in rep.phases] == ["dl:fcfs", "ul:fcfs",
                                                   "ul:bs"]
        assert results[0].sync_time == OP_POINT_SYNC
        assert rep.delay_percentiles["fcfs@load0.8"]["n"] == 12.0
    elif what == "cps":
        assert all("cps_utilization" in p for p in rep.phases)
    elif what == "rounds":
        assert len(rep.rounds) == 2 * 3
    elif what == "staleness":
        assert any(k > 0 for k in jc.staleness)
    elif what == "faults":
        kinds = {e["kind"] for e in jc.events}
        assert kinds >= {"fault.dropout", "fault.loss", "fault.gave_up",
                         "quorum.extend"}, kinds
    elif what == "jobs":
        assert {k[0] for k in jc.delay_hist} >= {
            "fcfs/job0", "fcfs/job1", "bs/job0", "bs/job1"}
    elif what == "slack":
        assert rep.slack_percentiles and any(
            r["n_deferred"] + r["n_dropped"] + r["n_partial"]
            for r in rep.rounds)


@pytest.mark.parametrize("name", list(RUNS))
def test_report_equals_the_reference(name):
    pon, cases, sched, mode, _ = RUNS[name]
    jc, tc = _pair_collectors()
    jspec = J.SweepSpec(cases=tuple(cases), pon=pon, schedule=sched,
                        mode=mode)
    want = J.simulate(jspec, collector=jc)
    spec = _port_spec(pon, cases, sched, mode)
    got = T.simulate(spec, collector=tc, device="cpu")
    _held(name, jc, got)
    _assert_collectors(jc, tc)
    # collector=None: the same run bit for bit
    assert repr(T.simulate(spec, device="cpu")) == repr(got)
    assert len(want) == len(got)


def test_fold_boundaries_do_not_change_the_report(monkeypatch):
    """Folds every 7 cycles or 500 buffered row elements (the row sums
    of many cycles in one ``np_sum``, a tail fold at the report) give the
    reference's report all the same."""
    monkeypatch.setattr(tobs.PhaseStats, "_CHUNK", 7)
    monkeypatch.setattr(tobs.PhaseStats, "_ROW_BUDGET", 500)
    pon, cases, sched, mode, _ = RUNS["cps-3pon"]
    jc, tc = _pair_collectors()
    J.simulate(J.SweepSpec(cases=tuple(cases), pon=pon), collector=jc)
    T.simulate(_port_spec(pon, cases, sched, mode), collector=tc,
               device="cpu")
    # the upload phases run ~500 cycles: dozens of folds each
    assert sum(p.cycles.max() > 10 * 7 for p in tc.phases) == 2
    _assert_collectors(jc, tc)


def test_legacy_entry_points_take_the_collector():
    """``simulate_round_sweep``, ``simulate_timeline_sweep`` and
    ``simulate_timeline_per_round`` (spec and legacy forms) record what
    ``simulate`` records."""
    cases = _cases("fcfs")
    tcases = T.from_reference(cases)
    pon = T.from_reference(CFG)
    sched = T.TimelineSchedule(n_rounds=2, deadline_s=DEADLINE)
    spec = T.SweepSpec(cases=tuple(tcases), pon=pon)
    tspec = spec.with_schedule(sched)
    reports = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for call in (
                lambda c: T.simulate(spec, collector=c, device="cpu"),
                lambda c: T.simulate_round_sweep(spec, collector=c,
                                                 device="cpu"),
                lambda c: T.simulate_round_sweep(pon, tcases, collector=c,
                                                 device="cpu"),
                lambda c: T.simulate(tspec, collector=c, device="cpu"),
                lambda c: T.simulate_timeline_sweep(tspec, collector=c,
                                                    device="cpu"),
                lambda c: T.simulate_timeline_sweep(
                    pon, tcases, sched, collector=c, device="cpu"),
                lambda c: T.simulate_timeline_per_round(
                    pon, tcases, sched, collector=c, device="cpu")):
            col = tobs.Collector(device="cpu")
            call(col)
            reports.append(col.report().to_dict())
    assert reports[0] == reports[1] == reports[2]
    assert reports[3] == reports[4] == reports[5] == reports[6]
    assert len(reports[3]["rounds"]) == 2


def test_jit_refuses_a_collector():
    spec = _port_spec(CFG, _cases("fcfs"), None, "auto", backend="jit")
    with pytest.raises(ValueError, match="does not support collector"):
        T.simulate(spec, collector=tobs.Collector(device="cpu"),
                   device="cpu")


# -- co-simulation ---------------------------------------------------------------

COSIM_RUNS = {
    "sync": ({}, {}),
    "coupled": ({}, dict(deadline_s=cosim_tests.DEADLINE,
                         deadline_policy="partial")),
}


@pytest.mark.parametrize("name", list(COSIM_RUNS))
def test_cosim_report_equals_the_reference(ref_params, name):
    cfg, run = COSIM_RUNS[name]
    ref, port, _, _ = cosim_tests._pair(ref_params, **cfg)
    jc, tc = _pair_collectors()
    ref.run(2, collector=jc, **run)
    got = port.run(2, collector=tc, **run)
    kinds = [e["kind"] for e in tc.events]
    assert kinds.count("fl_round") == 2
    if name == "sync":
        names = [e["name"] for e in tc.tracer.events]
        assert names.count("fl:train_round") == 2
    # the spans' order holds; their durations are the host's
    _assert_collectors(jc, tc)
    # collector=None: the same run bit for bit
    _, plain, _, _ = cosim_tests._pair(ref_params, **cfg)
    assert repr(plain.run(2, **run).rounds) == repr(got.rounds)


def test_cosim_config_takes_a_collector(ref_params):
    """``CoSimConfig.collector`` turns metrics on as ``run(collector=)``
    does."""
    from repro_torch import fl as tfl

    _, port, _, _ = cosim_tests._pair(ref_params)
    col = tobs.Collector(device="cpu")
    sim = tfl.FLNetworkCoSim(
        port.server, dataclasses.replace(port.cfg, collector=col),
        device="cpu")
    sim.run(1)
    assert [e["kind"] for e in col.events] == ["fl_round"]
    assert col.rounds and col.phases


# -- serve -------------------------------------------------------------------------

def test_serve_writes_one_event(tmp_path, capsys):
    path = tmp_path / "ev.jsonl"
    serve_mod.serve(max_new_tokens=2, prompt_len=8, batch=2,
                    log_jsonl=str(path), device="cpu")
    echo = capsys.readouterr().out.strip().splitlines()
    events = [json.loads(s) for s in path.read_text().splitlines()]
    assert len(events) == 1 and events[0]["event"] == "serve"
    ev = events[0]
    assert ev["arch"] == "olmo-1b" and ev["batch"] == 2
    for key in ("prefill_ms", "decode_ms", "tps"):
        assert ev[key] > 0
    assert echo[-1] == (
        f"olmo-1b: prefill(2x8)={ev['prefill_ms']:.1f}ms decode 2 "
        f"steps={ev['decode_ms']:.1f}ms ({ev['tps']:.1f} tok/s batched)")
