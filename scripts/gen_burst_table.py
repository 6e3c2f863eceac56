"""Rebuild the geometric burst-length breakpoint table of the PyTorch port.

The JAX package maps a 24-bit uniform to a geometric burst length
through ``repro.kernels.traffic.ref.geometric_lut``, a monotone int32
table over all 2**24 inputs evaluated once in XLA float32. The port
holds the same map as its runs: ``STARTS[i]`` is the first input of run
``i`` and ``LENGTHS[i]`` its length. This script prints the literal
that ``src/repro_torch/kernels/traffic/tables.py`` checks in:

    PYTHONPATH=src python scripts/gen_burst_table.py
"""
from __future__ import annotations

import numpy as np


def breakpoints(inv_burst: float = 1.0 / 16.0):
    """``(starts, lengths)`` int lists of the reference LUT's runs."""
    from repro.kernels.traffic.ref import geometric_lut

    lut = np.asarray(geometric_lut(inv_burst))
    starts = np.concatenate([[0], np.flatnonzero(np.diff(lut)) + 1])
    return starts.tolist(), lut[starts].tolist()


def _literal(name: str, values) -> str:
    body = ", ".join(str(int(v)) for v in values)
    lines, line = [], "    "
    for tok in body.split(" "):
        if len(line) + len(tok) + 1 > 76:
            lines.append(line.rstrip())
            line = "    "
        line += tok + " "
    lines.append(line.rstrip())
    return f"{name} = (\n" + "\n".join(lines) + "\n)\n"


if __name__ == "__main__":
    starts, lengths = breakpoints()
    print(_literal("STARTS_1_16", starts))
    print(_literal("LENGTHS_1_16", lengths))
