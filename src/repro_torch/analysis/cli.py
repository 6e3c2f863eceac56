"""Command-line entry point: ``python -m repro_torch.analysis``.

Exit codes are the reference pass's: 0 = clean (modulo baseline),
1 = non-baselined findings (or failed self-test), 2 = wiring error
(nothing scanned, unreadable baseline, unknown rule code): a
misconfigured pass must never read as a passing one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis import ANALYSIS_VERSION
from repro_torch.analysis.baseline import apply_baseline, load_baseline
from repro_torch.analysis.core import all_checkers, load_modules, run_checkers
from repro_torch.analysis.registry import registry_payload

DEFAULT_BASELINE = "analysis-baseline-torch.json"


def _default_paths() -> List[str]:
    for candidate in ("src/repro_torch", "repro_torch"):
        if os.path.isdir(candidate):
            return [candidate]
    return []


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "invariant-aware static analysis of the PyTorch/CUDA port "
            "(RPA0xx rules, README: Static analysis of the port)"
        ),
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files/directories to scan (default: src/repro_torch)",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format on stdout",
    )
    ap.add_argument(
        "--baseline", metavar="FILE", default=None,
        help=(
            f"baseline suppression file (default: {DEFAULT_BASELINE} "
            f"when present)"
        ),
    )
    ap.add_argument(
        "--output", metavar="PATH", default=None,
        help="additionally write the JSON report to PATH (CI artifact)",
    )
    ap.add_argument(
        "--select", metavar="CODES", default=None,
        help="comma-separated RPA codes to run (default: all)",
    )
    ap.add_argument(
        "--dump-registry", action="store_true",
        help="print the generated stream-key constant registry and exit",
    )
    ap.add_argument(
        "--self-test", action="store_true",
        help=(
            "verify every rule fires on its synthetic violating fixture "
            "and passes its fixed twin"
        ),
    )
    args = ap.parse_args(argv)

    if args.self_test:
        from repro_torch.analysis.selftest import run_self_test

        return run_self_test()

    paths = args.paths or _default_paths()
    if not paths:
        print(
            "error: no paths given and no src/repro_torch directory here",
            file=sys.stderr,
        )
        return 2
    try:
        modules = load_modules(paths)
    except (FileNotFoundError, SyntaxError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not modules:
        print(f"error: no python files under {paths}", file=sys.stderr)
        return 2

    if args.dump_registry:
        print(json.dumps(registry_payload(modules), indent=2))
        return 0

    select = args.select.split(",") if args.select else None
    try:
        checkers = all_checkers(select=select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline
    if baseline_path is None and os.path.isfile(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    entries = []
    if baseline_path is not None:
        try:
            entries = load_baseline(baseline_path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: baseline {baseline_path}: {e}", file=sys.stderr)
            return 2

    findings = run_checkers(modules, checkers)
    new, suppressed, stale = apply_baseline(findings, entries)

    payload = {
        "analysis_version": ANALYSIS_VERSION,
        "paths": list(paths),
        "rules": [
            {"code": c.code, "name": c.name, "description": c.description}
            for c in checkers
        ],
        "summary": {
            "files": len(modules),
            "findings": len(new),
            "baselined": len(suppressed),
            "stale_baseline_entries": len(stale),
        },
        "findings": [
            {
                "code": f.code, "path": f.path, "line": f.line,
                "col": f.col, "symbol": f.symbol, "message": f.message,
            }
            for f in new
        ],
        "baselined": [
            {
                "code": f.code, "path": f.path, "line": f.line,
                "symbol": f.symbol,
            }
            for f in suppressed
        ],
        "stale_baseline_entries": [
            {"code": e.code, "path": e.path, "symbol": e.symbol}
            for e in stale
        ],
    }

    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")

    if args.format == "json":
        print(json.dumps(payload, indent=2))
    else:
        for f in new:
            print(f"{f.location()}: {f.code} [{f.symbol}] {f.message}")
        for e in stale:
            print(
                f"warning: stale baseline entry {e.code} {e.path} "
                f"[{e.symbol}] matches nothing — remove it",
                file=sys.stderr,
            )
        print(
            f"{len(modules)} files: {len(new)} finding(s), "
            f"{len(suppressed)} baselined, {len(stale)} stale baseline "
            f"entr{'y' if len(stale) == 1 else 'ies'}",
            file=sys.stderr,
        )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
