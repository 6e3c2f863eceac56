"""The port's bandwidth slicing and slot schedule against ``repro.core``.

All host Python; on the ``tests/test_slicing.py`` and
``tests/test_properties.py`` inputs the port must give exactly equal
slices, slots, slot arrays, polling-cycle grants, round deadlines, the
analytic BS round time and the membership manager's slices.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
from repro.core import scheduler as ref_sched
from repro.core import slicing as ref_slicing
import repro_torch.core as core
from repro_torch.core import scheduler, slicing

C = 10e9
M = 26.416e6

# (t_uds, compute_slice kwargs) from tests/test_slicing.py
CASES = [
    ([1.0, 3.0, 5.0], dict(t_current=0.0, t_round=10.0)),
    ([1.0, 5.0], dict(t_current=0.0, t_round=10.0, sizing="paper")),
    ([1.0, 5.0], dict(t_current=0.0, t_round=10.0)),
    ([1.0, 1.0 + 1e-6] * 64, dict(t_current=0.0, t_round=10.0)),
    ([1.0, 1.0 + 1e-6] * 64, dict(t_current=0.0, t_round=10.0,
                                  sizing="paper")),
    ([1.0, 2.0], dict(t_current=100.0, t_round=7.5, h=3)),
    (list(np.random.default_rng(42).uniform(1.0, 5.0, 12)),
     dict(t_current=0.0, t_round=0.0)),
]


def _clients(mod, t_uds, t_dl=0.01):
    return [mod.ClientProfile(client_id=i, t_ud=float(t), t_dl=t_dl,
                              m_ud_bits=M)
            for i, t in enumerate(t_uds)]


@pytest.mark.parametrize("t_uds,kw", CASES)
def test_compute_slice_equal(t_uds, kw):
    want = ref_slicing.compute_slice(_clients(ref_slicing, t_uds),
                                     capacity_bps=C, **kw)
    got = slicing.compute_slice(_clients(slicing, t_uds),
                                capacity_bps=C, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("t_uds,kw", CASES)
def test_schedule_and_arrays_equal(t_uds, kw):
    ref_cl = _clients(ref_slicing, t_uds)
    cl = _clients(slicing, t_uds)
    spec_r = ref_slicing.compute_slice(ref_cl, capacity_bps=C, **kw)
    spec = slicing.compute_slice(cl, capacity_bps=C, **kw)
    want = ref_sched.schedule_slots(ref_cl, spec_r, round_start=0.0)
    got = scheduler.schedule_slots(cl, spec, round_start=0.0)
    assert [dataclasses.asdict(s) for s in got] == [
        dataclasses.asdict(s) for s in want]
    a, b = ref_sched.slots_to_arrays(want), scheduler.slots_to_arrays(got)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype
        assert np.array_equal(a[name], b[name])


def test_empty_schedule_arrays():
    a, b = ref_sched.slots_to_arrays([]), scheduler.slots_to_arrays([])
    assert all(np.array_equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("t_uds,h", [([1.0], 0), ([], 1)])
def test_invalid_slices_raise(t_uds, h):
    with pytest.raises(ValueError):
        slicing.compute_slice(_clients(slicing, t_uds), 0.0, 1.0, C, h=h)


# (t_ud, t_dl, m_ud) triples in the ranges of tests/test_properties.py
PROFILES = [
    [(0.1, 0.0, 1e3)],
    [(30.0, 2.0, 1e9), (0.1, 0.0, 1e3), (5.0, 1.0, 5e8)],
    [tuple(x) for x in np.random.default_rng(3).uniform(
        (0.1, 0.0, 1e3), (30.0, 2.0, 1e9), (64, 3))],
    [tuple(x) for x in np.random.default_rng(4).uniform(
        (0.1, 0.0, 1e3), (30.0, 2.0, 1e9), (17, 3))],
]


def _profiles(mod, triples):
    return [mod.ClientProfile(client_id=i, t_ud=float(t), t_dl=float(d),
                              m_ud_bits=float(m))
            for i, (t, d, m) in enumerate(triples)]


@pytest.mark.parametrize("triples", PROFILES)
def test_bs_round_time_equal(triples):
    want = ref_core.bs_round_time(_profiles(ref_slicing, triples), C,
                                  t_aggregate=0.25)
    got = core.bs_round_time(_profiles(slicing, triples), C,
                             t_aggregate=0.25)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("t_uds,kw", CASES)
def test_schedule_tools_equal(t_uds, kw):
    ref_cl, cl = _clients(ref_slicing, t_uds), _clients(slicing, t_uds)
    spec_r = ref_slicing.compute_slice(ref_cl, capacity_bps=C, **kw)
    spec = slicing.compute_slice(cl, capacity_bps=C, **kw)
    want = ref_sched.schedule_slots(ref_cl, spec_r, round_start=0.0)
    got = scheduler.schedule_slots(cl, spec, round_start=0.0)
    assert scheduler.schedule_makespan(got) == ref_sched.schedule_makespan(
        want)
    assert [dataclasses.asdict(g) for g in scheduler.map_to_polling_cycles(
        got, spec, 1e-3)] == [dataclasses.asdict(g) for g in
                              ref_sched.map_to_polling_cycles(
                                  want, spec_r, 1e-3)]
    scheduler.validate_schedule(cl, got, spec, round_start=0.0)
    for t_round in (1.0, 10.0, spec.t_max):
        assert slicing.validate_round_deadline(cl, spec, t_round, 0.1) == \
            ref_slicing.validate_round_deadline(ref_cl, spec_r, t_round, 0.1)
    assert slicing.min_round_time(cl, C, 0.1) == ref_slicing.min_round_time(
        ref_cl, C, 0.1)


def test_validate_schedule_catches_overlap():
    cl = _clients(slicing, [1.0, 2.0])
    spec = slicing.compute_slice(cl, 0.0, 0.0, C)
    slots = scheduler.schedule_slots(cl, spec, round_start=0.0)
    # the first slot moved late, into the second
    start = slots[1].t_start - slots[0].duration / 2
    bad = [dataclasses.replace(slots[0], t_start=start,
                               t_end=start + slots[0].duration), slots[1]]
    with pytest.raises(AssertionError, match="overlapping"):
        scheduler.validate_schedule(cl, bad, spec, round_start=0.0)
    assert scheduler.schedule_makespan([]) == 0.0
    assert scheduler.map_to_polling_cycles([], spec) == []


def test_download_and_compute_times_equal():
    assert core.download_time(26.416e6, 10e9, 15_000.0) == \
        ref_core.download_time(26.416e6, 10e9, 15_000.0)
    a = core.heterogeneous_compute_times(9, np.random.default_rng(5))
    b = ref_core.heterogeneous_compute_times(9, np.random.default_rng(5))
    assert a == b


def test_slice_manager_equal():
    """tests/test_slicing.py's membership sequence through both managers:
    the same slices, recompute counts and event kinds."""
    mgrs = []
    for mod in (ref_core, core):
        sl = ref_slicing if mod is ref_core else slicing
        mgr = mod.SliceManager(capacity_bps=C, t_round=10.0)
        mgr.bootstrap(_clients(sl, [1.0, 2.0]))
        for t in range(5):
            mgr.on_round(float(t))
        mgr.join(sl.ClientProfile(99, 3.0, 0.01, M), t_now=5.0)
        mgr.leave(99, t_now=6.0)
        mgr.leave(12345, t_now=7.0)             # unknown: no re-trigger
        mgr.leave(0, t_now=8.0)
        state = [mgr.recompute_count, dataclasses.asdict(mgr.current_slice),
                 [(e.time, e.kind, e.client.client_id)
                  for e in mgr.event_log],
                 sorted(c.client_id for c in mgr.profile_set)]
        mgr.leave(1, t_now=9.0)
        state.append(mgr.current_slice)
        mgrs.append(state)
    assert mgrs[0] == mgrs[1]
    assert mgrs[1][0] == 4 and mgrs[1][-1] is None
