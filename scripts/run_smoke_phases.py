"""Run named phases of a checkout's ``chip_smoke.py`` on one CUDA card.

    python3 scripts/run_smoke_phases.py [--root DIR] PHASE [PHASE ...]

Imports ``chip_smoke`` from ``--root`` (by default this checkout) and
calls its ``phase_<PHASE>()`` functions in the order given, each
printing its own line; ``build`` first builds that checkout's kernels.
Pointing ``--root`` at another checkout (for example a parent commit
unpacked with ``git archive`` into a git-ignored directory) times the
two versions of a phase in one call on one card: run them in turns,
parent, this, this, parent. Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("run_smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    smoke = importlib.import_module("chip_smoke")
    print(f"root={os.path.abspath(args.root)}", flush=True)
    t0 = time.time()
    for name in args.phases:
        getattr(smoke, f"phase_{name}")()
    print(f"[phases] {time.time() - t0:.3f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
