"""The port's fault injection against ``repro.faults``, on the CPU.

* the fault streams: the six pinned fingerprints of
  ``tests/test_faults.py``, ``fault_uniforms`` bit for bit against the
  JAX package's, one entity or a batch alike, and the schedule's draws
  (dropouts, losses, outage windows);
* ``FaultSchedule``/``RetryPolicy`` validation, with the reference's
  errors;
* faulted timelines (``repro_torch.net.simulate`` with a
  ``TimelineSchedule(faults=...)``) in the sync (defer), async and
  quorum modes, and under drop/partial deadlines, outage-only folds, a
  3-PON topology and retries that give up, on the per-cycle loop and
  with ``backend="jit"`` (the phase kernel's plain version on the CPU),
  against the JAX package's numpy engine: each round's sync and every
  client's ``ul_done`` within 1e-9 s, ``failed`` (clients and served
  bits), ``lost``, ``retry_at`` and ``gave_up`` exactly, with arrivals,
  staleness and quorum outcomes;
* a trivial ``FaultSchedule`` bit for bit ``faults=None``;
* the co-simulation with faults and quorum (``accuracy_part``'s faulty
  modes at the co-sim tests' size) against the reference's.
"""
import re

import numpy as np
import pytest

import repro.net as J
import repro_torch.net as T
import test_torch_cosim as cosim_tests
from repro.faults import (
    FAULT_DROPOUT,
    FAULT_LOSS,
    FAULT_OUTAGE,
    FaultSchedule,
    RetryPolicy,
    fault_fingerprint,
    fault_key,
    fault_uniforms,
)
from repro_torch import faults as tf
from test_torch_timeline import _cases

CFG = J.PONConfig(n_onus=16, line_rate_bps=1e9)
SYNC_ABS = 1e-9
BITS_RTOL = 1e-6
BACKENDS = [None, "jit"]
CLASSES = (FAULT_DROPOUT, FAULT_OUTAGE, FAULT_LOSS)
ref_params = cosim_tests.ref_params


# -- streams ------------------------------------------------------------------

FINGERPRINTS = {
    (FAULT_DROPOUT, 0, 0): 0x4B14B5901A556C85,
    (FAULT_DROPOUT, 5, 7): 0x5379E8E3DA420974,
    (FAULT_OUTAGE, 0, 0): 0x770188B2C65163C8,
    (FAULT_OUTAGE, 5, 7): 0x4C4DA1B9F892DE6E,
    (FAULT_LOSS, 0, 0): 0x94778675CC2AA9A1,
    (FAULT_LOSS, 5, 7): 0xC0FAF1B1D2B640CD,
}


@pytest.mark.parametrize("key", list(FINGERPRINTS),
                         ids=[f"class{c}-r{r}-case{k}"
                              for c, r, k in FINGERPRINTS])
def test_pinned_fingerprints(key):
    cls, r, case = key
    assert tf.fault_fingerprint(3, cls, r, 16, case_seed=case) == \
        FINGERPRINTS[key] == fault_fingerprint(3, cls, r, 16, case_seed=case)


@pytest.mark.parametrize("cls", CLASSES)
def test_uniforms_bit_for_bit_and_chunk_invariant(cls):
    ids = np.arange(40)
    for seed, r, case in ((3, 2, 5), (0, 0, 0), (2 ** 32 + 7, 11, 2 ** 31)):
        assert tf.fault_key(seed, cls, case) == fault_key(seed, cls, case)
        want = fault_uniforms(seed, cls, r, ids, case_seed=case)
        got = tf.fault_uniforms(seed, cls, r, ids, case_seed=case)
        for a, b in zip(got, want):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)
            assert np.all((a > 0.0) & (a < 1.0))
        for i in (0, 17, 39):
            one = tf.fault_uniforms(seed, cls, r, int(i), case_seed=case)
            assert one == (got[0][i], got[1][i])
            assert one == fault_uniforms(seed, cls, r, int(i),
                                         case_seed=case)


def test_schedule_draws_match_reference():
    kw = dict(seed=5, dropout_rate=0.3, loss_rate=0.4, outage_rate=0.6,
              outage_duration_s=0.7, outage_start_max_s=1.5)
    want, got = FaultSchedule(**kw), tf.FaultSchedule(**kw)
    ids = list(range(0, 60, 3))
    for r in range(5):
        for case in (0, 9):
            assert got.dropouts(r, ids, case) == want.dropouts(r, ids, case)
            assert got.losses(r, ids, case) == want.losses(r, ids, case)
            np.testing.assert_array_equal(got.outage_windows(r, 7, case),
                                          want.outage_windows(r, 7, case))
    assert tf.FaultSchedule(dropout_rate=1.0).dropouts(0, ids).keys() == \
        set(ids)
    assert not tf.FaultSchedule(loss_rate=0.0).losses(0, ids)
    for attempt in range(1, 6):
        for p in ({}, dict(base_delay_rounds=2, backoff=1.5)):
            assert (tf.RetryPolicy(**p).delay_rounds(attempt)
                    == RetryPolicy(**p).delay_rounds(attempt))


VALIDATION = [
    ("dropout-rate", dict(dropout_rate=1.5)),
    ("loss-rate", dict(loss_rate=-0.1)),
    ("outage-rate", dict(outage_rate=2.0)),
    ("outage-duration", dict(outage_duration_s=0.0)),
    ("outage-start", dict(outage_start_max_s=-1.0)),
    ("retry-base", dict(base_delay_rounds=0)),
    ("retry-backoff", dict(backoff=0.5)),
    ("retry-max", dict(max_retries=-1)),
]


@pytest.mark.parametrize("kw", [v for _, v in VALIDATION],
                         ids=[n for n, _ in VALIDATION])
def test_validation_errors(kw):
    retry = next(iter(kw)) in ("base_delay_rounds", "backoff",
                               "max_retries")
    ref_cls = RetryPolicy if retry else FaultSchedule
    port_cls = tf.RetryPolicy if retry else tf.FaultSchedule
    with pytest.raises(ValueError) as want:
        ref_cls(**kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        port_cls(**kw)


def test_schedule_flags_and_type_errors():
    assert tf.FaultSchedule().trivial
    assert not tf.FaultSchedule(outage_rate=0.5).couples_rounds
    assert tf.FaultSchedule(loss_rate=0.1).couples_rounds
    sched = T.TimelineSchedule(n_rounds=2, faults=tf.FaultSchedule())
    assert sched.active_faults is None and not sched.couples_rounds
    assert sched.retry_policy == tf.RetryPolicy()
    assert T.TimelineSchedule(
        n_rounds=2, faults=tf.FaultSchedule(dropout_rate=0.1)).couples_rounds
    with pytest.raises(TypeError, match="FaultSchedule"):
        T.TimelineSchedule(n_rounds=1, faults=object())
    with pytest.raises(TypeError, match="RetryPolicy"):
        T.TimelineSchedule(n_rounds=1, retry=object())
    spec = T.SweepSpec(cases=tuple(T.from_reference(_cases("fcfs"))),
                       pon=T.from_reference(CFG))
    with pytest.raises(ValueError, match="needs a schedule"):
        spec.with_faults(tf.FaultSchedule())
    faulty = spec.with_schedule(T.TimelineSchedule(
        n_rounds=2, retry=tf.RetryPolicy(max_retries=1))).with_faults(
        tf.FaultSchedule(loss_rate=0.5))
    assert faulty.schedule.retry == tf.RetryPolicy(max_retries=1)
    assert faulty.schedule.faults == tf.FaultSchedule(loss_rate=0.5)


# -- faulted timelines --------------------------------------------------------

FAULTS = dict(seed=3, dropout_rate=0.3, loss_rate=0.2, outage_rate=0.6,
              outage_duration_s=0.2, outage_start_max_s=0.3)
TOPO3 = J.MultiPonTopology(n_pons=3, cps_rate_bps=2.4e9)


def _scenarios():
    """name -> (cases, schedule, mode, pon): every mode under dropout,
    loss and outages (16 ONUs, 1 Gb/s, 4 rounds)."""
    f = FaultSchedule(**FAULTS)
    out = {}
    for pol in ("fcfs", "bs"):
        cases = _cases(pol)
        out[f"sync-{pol}"] = (cases, J.TimelineSchedule(
            n_rounds=4, deadline_s=0.4, faults=f), "auto", CFG)
        out[f"async-{pol}"] = (cases, J.TimelineSchedule(
            n_rounds=4, buffer_k=3, faults=f), "auto", CFG)
        out[f"quorum-{pol}"] = (cases, J.TimelineSchedule(
            n_rounds=4, deadline_s=0.3, deadline_policy="drop",
            quorum_frac=0.75, faults=f), "auto", CFG)
        out[f"partial-giveup-{pol}"] = (cases, J.TimelineSchedule(
            n_rounds=4, deadline_s=0.35, deadline_policy="partial",
            faults=FaultSchedule(seed=1, dropout_rate=0.5, loss_rate=0.5),
            retry=RetryPolicy(max_retries=1)), "auto", CFG)
        out[f"pons3-sync-{pol}"] = (
            _cases(pol, (0.4,), (5,), TOPO3), J.TimelineSchedule(
                n_rounds=3, deadline_s=0.4, faults=f), "auto",
            J.PONConfig(n_onus=8, line_rate_bps=1e9))
    # outage-only schedules still fold (FCFS: an outage-cut BS slot is
    # never served again without a deadline, as in the reference)
    outages = FaultSchedule(seed=3, outage_rate=0.7, outage_duration_s=0.2,
                            outage_start_max_s=0.3)
    for mode in ("folded", "sequential"):
        out[f"outage-{mode}-fcfs"] = (_cases("fcfs"), J.TimelineSchedule(
            n_rounds=3, faults=outages), mode, CFG)
    return out


SCENARIOS = _scenarios()


def _ref(cases, sched, mode, pon):
    return J.simulate(J.SweepSpec(cases=tuple(cases), pon=pon,
                                  schedule=sched, mode=mode))


def _port(cases, sched, mode, pon, backend):
    return T.simulate(T.SweepSpec(
        cases=tuple(T.from_reference(list(cases))),
        pon=T.from_reference(pon), schedule=T.from_reference(sched),
        mode=mode, backend=backend), device="cpu")


def _assert_faulted(want, got):
    assert len(want) == len(got)
    for a_tl, b_tl in zip(want, got):
        assert len(a_tl.rounds) == len(b_tl.rounds)
        for x, y in zip(a_tl.rounds, b_tl.rounds):
            what = f"round {x.round_index}"
            for name in ("sync_time", "t_start", "t_end"):
                assert abs(getattr(y, name) - getattr(x, name)) <= \
                    SYNC_ABS, (what, name)
            for name in ("failed", "lost", "retry_at", "gave_up", "arrived",
                         "staleness", "quorum_met", "deadline_extensions"):
                assert getattr(y, name) == getattr(x, name), (what, name)
            for name in ("ul_bits", "deferred", "dropped", "partial"):
                xd, yd = getattr(x, name), getattr(y, name)
                assert set(xd) == set(yd), (what, name)
                for cid, v in xd.items():
                    assert yd[cid] == pytest.approx(v, rel=BITS_RTOL)
            assert (x.result is None) == (y.result is None)
            if x.result is not None:
                a, b = x.result.ul_done, y.result.ul_done
                assert set(a) == set(b), what
                for cid in a:
                    assert (np.isnan(a[cid]) and np.isnan(b[cid])) or abs(
                        a[cid] - b[cid]) <= SYNC_ABS, (what, cid)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_faulted_timeline_matches_reference(name, backend):
    cases, sched, mode, pon = SCENARIOS[name]
    want = _ref(cases, sched, mode, pon)
    _assert_faulted(want, _port(cases, sched, mode, pon, backend))
    rounds = [r for tl in want for r in tl.rounds]
    if "outage" not in name:
        assert any(r.failed for r in rounds) and any(
            r.retry_at for r in rounds), name
    if "giveup" in name:
        assert any(r.gave_up for r in rounds) and any(
            r.lost for r in rounds)
    if name.startswith("quorum"):
        assert any(r.deadline_extensions for r in rounds)


@pytest.mark.parametrize("backend", BACKENDS)
def test_trivial_faults_bitwise_none(backend):
    pc = tuple(T.from_reference(_cases("fcfs")))
    runs = []
    for faults in (None, tf.FaultSchedule(seed=9)):
        runs.append(T.simulate(T.SweepSpec(
            cases=pc, pon=T.from_reference(CFG), backend=backend,
            schedule=T.TimelineSchedule(n_rounds=3, deadline_s=0.3,
                                        quorum_frac=0.8, faults=faults)),
            device="cpu")[0])
    a, b = runs
    assert a.sync_times.tolist() == b.sync_times.tolist()
    for x, y in zip(a.rounds, b.rounds):
        assert x.result.ul_done.keys() == y.result.ul_done.keys()
        np.testing.assert_array_equal(list(x.result.ul_done.values()),
                                      list(y.result.ul_done.values()))
        assert (x.arrived, x.deferred) == (y.arrived, y.deferred)


def test_coupling_faults_refuse_folding():
    for mod, faults in ((J, FaultSchedule(dropout_rate=0.1)),
                        (T, tf.FaultSchedule(dropout_rate=0.1))):
        spec = mod.SweepSpec(
            cases=tuple(_cases("fcfs") if mod is J
                        else T.from_reference(_cases("fcfs"))),
            pon=CFG if mod is J else T.from_reference(CFG),
            schedule=mod.TimelineSchedule(n_rounds=2, faults=faults),
            mode="folded")
        with pytest.raises(ValueError, match="outage-only"):
            mod.simulate(spec, **({} if mod is J else {"device": "cpu"}))


# -- co-simulation ------------------------------------------------------------

COSIM_FAULTS = dict(seed=3, dropout_rate=0.3, loss_rate=0.3, outage_rate=0.5,
                    outage_duration_s=0.5, outage_start_max_s=2.0)
COSIM_RUNS = {
    "faulty": (dict(faults=FaultSchedule(**COSIM_FAULTS)),
               dict(deadline_s=cosim_tests.DEADLINE,
                    deadline_policy="drop")),
    "faulty_quorum": (dict(faults=FaultSchedule(**COSIM_FAULTS),
                           quorum_frac=0.5),
                      dict(deadline_s=cosim_tests.DEADLINE,
                           deadline_policy="drop")),
    # without a deadline a BS upload whose slot an outage darkened waits
    # for max_t (in both packages): these runs draw no outage under BS
    "faulty_giveup_async": (dict(faults=FaultSchedule(
        seed=3, dropout_rate=0.3, loss_rate=0.3),
        retry=RetryPolicy(max_retries=0)),
        dict(mode="async", async_buffer=2)),
    "outage_timeline": (dict(timing_seeds=2, policy="fcfs",
                             faults=FaultSchedule(
                                 seed=3, outage_rate=0.8,
                                 outage_duration_s=0.5,
                                 outage_start_max_s=2.0)), dict()),
}


@pytest.mark.parametrize("name", list(COSIM_RUNS))
def test_cosim_with_faults_matches_reference(ref_params, name):
    cfg, run = COSIM_RUNS[name]
    ref, port, jtest, ttest = cosim_tests._pair(ref_params, **cfg)
    want = ref.run(cosim_tests.ROUNDS,
                   eval_fn=lambda p: cosim_tests.jcnn.accuracy(p, jtest),
                   **run)
    got = port.run(cosim_tests.ROUNDS,
                   eval_fn=lambda p: cosim_tests.tcnn.accuracy(p, ttest),
                   **run)
    cosim_tests._assert_same(want, got, len(jtest["labels"]))
    for a, b in zip(want.rounds, got.rounds):
        assert (a.get("n_failed"), a.get("n_lost")) == (
            b.get("n_failed"), b.get("n_lost"))
    if name != "outage_timeline":
        assert any(r["n_failed"] or r["n_lost"] for r in got.rounds)


def test_cosim_fault_restrictions(ref_params):
    for mod_cfg, run in (
            (dict(faults=FaultSchedule(dropout_rate=0.1)), dict()),
            (dict(quorum_frac=0.5), dict())):
        ref, port, _, _ = cosim_tests._pair(ref_params, **mod_cfg)
        with pytest.raises(ValueError) as want:
            ref.run(1, **run)
        with pytest.raises(ValueError,
                           match=re.escape(str(want.value)[:40])):
            port.run(1, **run)
