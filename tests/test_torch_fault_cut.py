"""``chip_smoke.py`` runs each fault cell with outages over its mode's
first ``FAULT_OUTAGE_ROUNDS`` rounds and holds there
``FAULT_OUTAGE_FALLBACKS`` phases re-run on the per-cycle loop. Here
the port's ``backend="jit"`` on the CPU (the phase kernel's plain
version) runs each mode's dropout 0.2 x outage 0.5 cell at that depth:
the count, each fallback an upload phase under an outage longer than
the background ring, and the rounds equal to the first of
``FAULT_PINS``' (recomputed with the JAX package in
``test_torch_fault_pins.py``)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


@pytest.mark.parametrize("mode", list(CS.FAULT_MODES))
def test_outage_cell_fallbacks_at_the_smoke_depth(mode, monkeypatch):
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
    d, o = CS.FAULT_DROPOUTS[-1], CS.FAULT_OUTAGES[-1]
    rounds = CS.FAULT_OUTAGE_ROUNDS[mode]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the loop's tensors are one row of 128 ONUs
    try:
        res = simulate(CS.faults_spec(mode, d, o, "jit", rounds),
                       device="cpu")
    finally:
        torch.set_num_threads(threads)
    want = CS.FAULT_OUTAGE_FALLBACKS[mode]
    assert engine.phase_fallbacks == len(fell) == want > 0
    assert all(c >= HISTORY_CYCLES for c in fell)
    assert (CS.fault_outcomes(res[0])
            == CS.FAULT_PINS[f"{mode}_d{d}_o{o}"][:rounds])
