"""The values ``chip_smoke.py`` pins for its ``faults`` phase, recomputed
with the JAX package (its numpy engine) on the CPU: every cell of
``benchmarks/faults.py``'s grid (the op point, 6 rounds, dropout
{0, 0.2} x outage {0, 0.5}, modes sync, async and quorum), each round's
sync, failed clients and their served bits, lost clients, retry rounds,
give-ups and deadline extensions (``fault_outcomes``). One test a cell:
the grid takes about two minutes on the reference."""
import importlib.util
import pathlib

import pytest

import repro.net as J
from repro.core.slicing import ClientProfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()
CELLS = CS.fault_cells()


def reference_pin(mode: str, dropout: float, outage: float) -> tuple:
    """One cell of the grid on the JAX package."""
    spec = CS.faults_spec(mode, dropout, outage, types=(J, ClientProfile))
    return CS.fault_outcomes(J.simulate(spec)[0])


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_chip_smoke_fault_pins_equal_the_reference(cell):
    name, mode, dropout, outage = cell
    assert CS.FAULT_PINS[name] == reference_pin(mode, dropout, outage)


def test_pins_cover_the_grid():
    assert set(CS.FAULT_PINS) == {c[0] for c in CELLS}
    # the grid fails, retries and extends somewhere
    rounds = [r for pin in CS.FAULT_PINS.values() for r in pin]
    assert any(r[1] for r in rounds) and any(r[3] for r in rounds)
    assert any(r[5] for r in rounds)


def test_sync_outage_cell_fallbacks_on_cpu(monkeypatch):
    """The sync dropout 0.2 x outage 0.5 cell through the port's
    ``backend="jit"`` on the CPU (the phase kernel's plain version)
    re-runs ``FAULT_FALLBACKS["sync"]`` phases on the per-cycle loop,
    each an upload phase under an outage longer than the background
    ring, and still gives the pinned outcomes."""
    import numpy as np

    from repro_torch.kernels.ponsim.ref import HISTORY_CYCLES
    from repro_torch.net import engine, simulate

    run = engine.run_phase_device
    fell = []

    def counted(*args, **kwargs):
        out = run(*args, **kwargs)
        if out is None:
            dark = kwargs.get("outage_row")
            fell.append(0.0 if dark is None else float(np.max(np.where(
                np.isfinite(dark[:, 0]), dark[:, 1] - dark[:, 0], 0.0)))
                / args[0].cycle_time_s)
        return out

    monkeypatch.setattr(engine, "run_phase_device", counted)
    monkeypatch.setattr(engine, "phase_fallbacks", 0)
    res = simulate(CS.faults_spec("sync", 0.2, 0.5, "jit"), device="cpu")
    assert engine.phase_fallbacks == len(fell) == CS.FAULT_FALLBACKS["sync"]
    assert all(c >= HISTORY_CYCLES for c in fell)
    assert CS.fault_outcomes(res[0]) == CS.FAULT_PINS["sync_d0.2_o0.5"]
