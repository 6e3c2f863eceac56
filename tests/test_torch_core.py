"""The port's bandwidth slicing and slot schedule against ``repro.core``.

Both are host Python; on the ``tests/test_slicing.py`` inputs the port
must give exactly equal slices, slots and slot arrays.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import scheduler as ref_sched
from repro.core import slicing as ref_slicing
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
