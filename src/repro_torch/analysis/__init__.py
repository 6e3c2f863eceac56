"""Invariant-aware static analysis for the PyTorch/CUDA port.

The port's reproducibility rests on the same source-level contracts as
the JAX package's (counter-based streams only, no ambient precision
flips, host-sync-free code where the card dispatches or the dry run
traces, disjoint stream-key derivation constants, bitwise-uninstrumented
``collector=None`` paths and the ``kernel.py``/``ref.py``/``ops.py``
triple per kernel), restated in PyTorch's idiom. Runtime tests catch a
violation only where they happen to reach it; this package checks the
source::

    python -m repro_torch.analysis [--format text|json] [--baseline FILE] [paths...]

Rule codes are the JAX package's ``RPA0xx`` codes, each read for the
port's contracts (README, "Static analysis of the port"). Justified
exemptions live in ``analysis-baseline-torch.json``. The package is
stdlib-only, as the reference's is: it runs without torch or numpy.
"""

from repro_torch.analysis.core import (  # noqa: F401
    Checker,
    Finding,
    ModuleInfo,
    all_checkers,
    load_modules,
    run_checkers,
)

#: Stamped into JSON reports; bump on any rule-behaviour change so
#: artifacts record which pass produced them.
ANALYSIS_VERSION = "1.0.0"

__all__ = [
    "ANALYSIS_VERSION",
    "Checker",
    "Finding",
    "ModuleInfo",
    "all_checkers",
    "load_modules",
    "run_checkers",
]
