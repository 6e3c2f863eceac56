"""The port's DBAs (``repro_torch.net.dba``) against ``repro.net.dba``.

Seeded random queue states, built the same way on both sides: a few
segments an ONU of background and owner-tagged FL traffic, arrival
times drawn from a short list so that head-of-line times tie across
queues, empty queues among them. Held bit for bit (both sides are the
same host float arithmetic): ``OnuQueue``'s push, backlog,
``backlog_of``, ``hol_time``/``hol_time_of`` and ``serve`` (its drained
bits by exact kind, in their order, and the survivors), and the grants
of ``FCFSBestEffort`` and ``SlicedDBA``, insertion order included,
under ``cap_bits`` that binds, does not bind and is spent, with slots
whose edges fall on the cycle's own edges, its grace cycle and outside.
"""
import numpy as np
import pytest

import repro.net.dba as jdba
import repro_torch.net.dba as tdba
from repro.core.scheduler import SlotAssignment as JSlot
from repro_torch.core.scheduler import SlotAssignment as TSlot

CYCLE = 1e-3
LINE = 1e9
TIMES = (0.0, 0.0005, 0.001, 0.002, 0.002, 0.003)


def _ops(rng, n_onus, n_segs):
    """Pushes ``(onu, kind, bits, t)``: bits from sub-bit to a few
    cycles' worth, some zero (ignored by ``push``)."""
    ops = []
    for _ in range(n_segs):
        onu = int(rng.integers(n_onus))
        kind = ("bg" if rng.random() < 0.5
                else ("fl", int(rng.integers(4))))
        bits = float(rng.choice([0.0, 0.5, rng.uniform(1.0, 3e5),
                                 rng.uniform(3e5, 3e6)]))
        ops.append((onu, kind, bits, float(rng.choice(TIMES))))
    return ops


def _queues(ops, n_onus):
    jq = [jdba.OnuQueue(i) for i in range(n_onus)]
    tq = [tdba.OnuQueue(i) for i in range(n_onus)]
    for onu, kind, bits, t in ops:
        jq[onu].push(kind, bits, t)
        tq[onu].push(kind, bits, t)
    return jq, tq


def _same_queues(jq, tq):
    for a, b in zip(jq, tq):
        assert b.onu_id == a.onu_id
        assert b.segments == a.segments
        assert b.hol_time == a.hol_time
        assert b.backlog == a.backlog
        for kind in ("bg", "fl"):
            assert b.backlog_of(kind) == a.backlog_of(kind)
            assert b.hol_time_of(kind) == a.hol_time_of(kind)


def _same_grants(a, b):
    assert list(b) == list(a)
    for onu in a:
        assert list(b[onu].items()) == list(a[onu].items()), onu


def test_kind_matches_owner_tags():
    for seg, kind in (("bg", "bg"), ("fl", "bg"), (("fl", 3), "fl"),
                      (("fl", 3), "bg"), (("bg", 1), "bg")):
        assert tdba._kind_matches(seg, kind) == jdba._kind_matches(seg,
                                                                   kind)


def test_empty_queue():
    q = tdba.OnuQueue(7)
    assert q.hol_time == np.inf and q.backlog == 0
    assert q.hol_time_of("fl") == np.inf
    q.push("bg", 0.0, 1.0)
    q.push("bg", -5.0, 1.0)
    assert q.segments == [] and q.hol_time == np.inf
    assert q.serve(10.0) == {} and q.hol_time == np.inf


@pytest.mark.parametrize("seed", range(6))
def test_queue_push_serve(seed):
    rng = np.random.default_rng(seed)
    n_onus = 6
    jq, tq = _queues(_ops(rng, n_onus, 40), n_onus)
    _same_queues(jq, tq)
    for _ in range(30):
        onu = int(rng.integers(n_onus))
        kind = rng.choice([None, "bg", "fl"])
        bits = float(rng.choice([0.0, 1e-10, 0.7, rng.uniform(1.0, 2e6),
                                 jq[onu].backlog]))
        got = tq[onu].serve(bits, kind=kind)
        want = jq[onu].serve(bits, kind=kind)
        assert list(got.items()) == list(want.items())
        _same_queues(jq, tq)
        if rng.random() < 0.3:
            for onu_, kind_, b, t in _ops(rng, n_onus, 3):
                jq[onu_].push(kind_, b, t)
                tq[onu_].push(kind_, b, t)


def _caps(rng, capacity):
    return [None, 0.5 * capacity, 2.0 * capacity, 1e-10,
            float(rng.uniform(0.0, capacity))]


@pytest.mark.parametrize("seed", range(6))
def test_fcfs_grant(seed):
    rng = np.random.default_rng(100 + seed)
    n_onus = int(rng.integers(3, 9))
    jq, tq = _queues(_ops(rng, n_onus, int(rng.integers(5, 40))), n_onus)
    jd = jdba.FCFSBestEffort(LINE, CYCLE, n_onus)
    td = tdba.FCFSBestEffort(LINE, CYCLE, n_onus)
    assert td.capacity_bits == jd.capacity_bits
    assert tdba.FCFSLimitedService is tdba.FCFSBestEffort
    assert tdba.DEFAULT_EFFICIENCY == jdba.DEFAULT_EFFICIENCY
    for cap in _caps(rng, jd.capacity_bits):
        _same_grants(jd.grant(jq, cap_bits=cap), td.grant(tq, cap_bits=cap))
    # serve the grants and grant again: queues drain as the reference's
    for _ in range(4):
        for queues, dba in ((jq, jd), (tq, td)):
            for onu, g in dba.grant(queues).items():
                for kind, bits in g.items():
                    queues[onu].serve(bits, kind=kind)
        _same_queues(jq, tq)
        _same_grants(jd.grant(jq), td.grant(tq))


def _slots(rng, n_onus, t):
    """Slots around cycle ``t``: edges on ``t``, ``t + cycle``, the grace
    cycle ``t - cycle`` and random points, some clients without a
    queue (ids past ``n_onus``)."""
    edges = [t - 2 * CYCLE, t - CYCLE, t - 0.5 * CYCLE, t,
             t + 0.25 * CYCLE, t + CYCLE, t + 2 * CYCLE]
    out = []
    for _ in range(int(rng.integers(1, 6))):
        a, b = sorted(float(x) for x in rng.choice(edges, 2))
        cid = int(rng.integers(n_onus + 2))
        out.append((cid, a, b, float(rng.uniform(1e3, 1e6))))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_sliced_grant(seed):
    rng = np.random.default_rng(200 + seed)
    n_onus = int(rng.integers(3, 8))
    jq, tq = _queues(_ops(rng, n_onus, int(rng.integers(5, 30))), n_onus)
    t = float(rng.choice([0.0, 0.003, 0.0121]))
    raw = _slots(rng, n_onus, t)
    rate = float(rng.choice([1e8, 5e8, 2e9]))
    jd = jdba.SlicedDBA(LINE, CYCLE, n_onus, rate,
                        [JSlot(c, a, b, bits) for c, a, b, bits in raw])
    td = tdba.SlicedDBA(LINE, CYCLE, n_onus, rate,
                        [TSlot(c, a, b, bits) for c, a, b, bits in raw])
    for tc in (t - CYCLE, t, t + CYCLE, t + 0.5 * CYCLE):
        assert ([(s.client_id, s.t_start, s.t_end)
                 for s in td.active_slots(tc)]
                == [(s.client_id, s.t_start, s.t_end)
                    for s in jd.active_slots(tc)])
        for cap in _caps(rng, jd.capacity_bits):
            _same_grants(jd.grant(jq, tc, cap_bits=cap),
                         td.grant(tq, tc, cap_bits=cap))
