"""The values ``chip_smoke.py`` pins for its collector holds
(``OBS_PINS``), recomputed with the JAX package (its numpy engine and
``repro.obs``) on the CPU, one cell a test:

* ``overhead``: ``benchmarks/obs_overhead.py``'s run (``fig3_cases()``,
  ``elastic_schedule(6)``, folded, 128 ONUs) under a collector with a
  span tracer: each phase's rows, cycles, utilisation-histogram n, bit
  totals and ``grant_utilization``, the upload-delay percentiles, the
  rounds recorded and the spans by name;
* ``fig2b``: ``benchmarks/fig2b_sync_time.py``'s sweep under
  ``Collector(keep_phases=False)``: the upload-delay percentiles;
* ``jobs``: each run of ``jobs_specs()``: each job's upload-delay n and
  p95 (``benchmarks/jobs.py``'s per-job p95);
* ``faults``: the faults phase's per-cycle cell
  (``FAULT_LOOP_CELL``, ``FAULT_LOOP_ROUNDS`` rounds): the events by
  kind and every round record.

It also checks that ``obs_spec`` is the benchmark's run, that
``_hold_obs`` takes the pins and refuses a value off by more than its
tolerance, and that the port's own run of the faults cell on the CPU
meets its pin.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

import repro.net as J
from repro.core.slicing import ClientProfile
from repro.obs import Collector, SpanTracer

ROOT = pathlib.Path(__file__).resolve().parents[1]
TYPES = (J, ClientProfile)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()
CELLS = ("overhead", "fig2b", "jobs", "faults")


def _benchmarks():
    sys.path.insert(0, str(ROOT))
    from benchmarks import fig2b_sync_time, timeline

    return fig2b_sync_time, timeline


def reference_pin(cell: str):
    """One cell of ``OBS_PINS`` on the JAX package."""
    if cell == "overhead":
        col = Collector(tracer=SpanTracer())
        J.simulate(CS.obs_spec(TYPES), collector=col)
        return CS.obs_pin(cell, col)
    if cell == "fig2b":
        fig2b, _ = _benchmarks()
        col = Collector(keep_phases=False)
        J.simulate(J.SweepSpec(cases=tuple(fig2b.sweep_cases()),
                               pon=J.PONConfig(n_onus=fig2b.N_ONUS)),
                   collector=col)
        return CS.obs_pin(cell, col)
    if cell == "jobs":
        out = {}
        for name, spec in CS.jobs_specs(types=TYPES).items():
            col = Collector()
            J.simulate(spec, collector=col)
            out[name] = CS.obs_pin(cell, col)
        return out
    mode, dropout, outage = CS.FAULT_LOOP_CELL
    col = Collector()
    J.simulate(CS.faults_spec(mode, dropout, outage,
                              rounds=CS.FAULT_LOOP_ROUNDS, types=TYPES),
               collector=col)
    return CS.obs_pin(cell, col)


@pytest.mark.parametrize("cell", CELLS)
def test_chip_smoke_obs_pins_equal_the_reference(cell):
    assert CS.OBS_PINS[cell] == reference_pin(cell)


def test_obs_spec_is_the_benchmarks_run():
    _, timeline = _benchmarks()
    spec = CS.obs_spec(TYPES)
    want = timeline.fig3_cases()
    assert [(c.policy, c.load, c.seed) for c in spec.cases] == [
        (c.policy, c.load, c.seed) for c in want]
    assert all(c.workload == w.workload for c, w in zip(spec.cases, want))
    sched = timeline.elastic_schedule(CS.OBS_ROUNDS)
    assert spec.schedule.n_rounds == sched.n_rounds
    np.testing.assert_array_equal(spec.schedule.membership,
                                  sched.membership)
    assert spec.mode == "folded" and spec.pon == J.PONConfig(n_onus=128)


def _perturbed(cell):
    """``(pin, a copy off by more than the hold's tolerance)`` pairs."""
    pin = CS.OBS_PINS[cell]
    if cell == "overhead":
        ph = list(pin["phases"])
        out = []
        for i, bump in ((2, 1), (4, 1e-11), (8, 1e-11)):
            row = list(ph[0])
            row[i] = row[i] + (bump if isinstance(row[i], int)
                               else row[i] * bump)
            out.append(dict(pin, phases=(tuple(row), *ph[1:])))
        key = next(iter(pin["delay"]))
        n, *pcts = pin["delay"][key]
        out.append(dict(pin, delay=dict(
            pin["delay"], **{key: (n, pcts[0] + 2e-9, *pcts[1:])})))
        out.append(dict(pin, spans=dict(pin["spans"], extra=1)))
        return out
    if cell == "faults":
        r0 = list(pin["rounds"][0])
        r0[-1] = ("ul_bits", 1.0)
        return [dict(pin, events={"fault.dropout": 6}),
                dict(pin, rounds=(tuple(r0), *pin["rounds"][1:]))]
    key = next(iter(pin))
    n, *pcts = pin[key]
    return [dict(pin, **{key: (n + 1, *pcts)}),
            dict(pin, **{key: (n, pcts[0] + 2e-9, *pcts[1:])})]


@pytest.mark.parametrize("cell", ("overhead", "fig2b", "faults"))
def test_hold_takes_the_pins_and_refuses_a_change(cell):
    pin = CS.OBS_PINS[cell]
    CS._hold_obs(cell, pin, pin, cell)
    for bad in _perturbed(cell):
        with pytest.raises(SystemExit, match="collector report"):
            CS._hold_obs(cell, bad, pin, cell)
    jobs = CS.OBS_PINS["jobs"]["maxmin_j4"]
    CS._hold_obs("jobs", jobs, jobs, "jobs")


def test_port_faults_cell_meets_its_pin_on_cpu():
    """The port's per-cycle loop on the CPU gives the faults cell's pin
    (the card run is held to it in ``chip_smoke.py``'s ``faults``)."""
    import repro_torch.net as T
    from repro_torch.obs import Collector as TCollector

    mode, dropout, outage = CS.FAULT_LOOP_CELL
    col = TCollector(device="cpu")
    T.simulate(CS.faults_spec(mode, dropout, outage,
                              rounds=CS.FAULT_LOOP_ROUNDS),
               collector=col, device="cpu")
    got = CS.obs_pin("faults", col)
    CS._hold_obs("faults", got, CS.OBS_PINS["faults"], "faults")
    assert got == CS.OBS_PINS["faults"]
