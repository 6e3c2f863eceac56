"""Baseline suppression: checked-in, justified pre-existing findings.

``analysis-baseline-torch.json`` holds entries of the form::

    {"code": "RPA005", "path": "src/repro_torch/kernels/x/ref.py",
     "symbol": "foo_ref", "note": "host-exact table build, not traced"}

Matching is on ``(code, path-suffix, symbol)`` — never line numbers, so
entries survive unrelated edits.  ``note`` is mandatory: an exemption
without a recorded justification is itself a finding.  Stale entries
(matching nothing) are reported so the file cannot silently rot.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.analysis.core import Finding


@dataclass(frozen=True)
class BaselineEntry:
    code: str
    path: str
    symbol: str
    note: str

    def matches(self, finding: Finding) -> bool:
        if self.code != finding.code:
            return False
        if not (
            finding.path.endswith(self.path) or self.path.endswith(finding.path)
        ):
            return False
        return self.symbol in ("*", finding.symbol)


def load_baseline(path: str) -> List[BaselineEntry]:
    with open(path, encoding="utf-8") as fh:
        payload = json.load(fh)
    entries = []
    for raw in payload.get("entries", []):
        missing = {"code", "path", "symbol", "note"} - set(raw)
        if missing:
            raise ValueError(
                f"baseline entry {raw!r} is missing {sorted(missing)} — "
                f"every exemption needs a code, location and justification"
            )
        if not str(raw["note"]).strip():
            raise ValueError(
                f"baseline entry {raw!r} has an empty note — record why "
                f"the finding is exempt"
            )
        entries.append(
            BaselineEntry(
                code=raw["code"], path=raw["path"],
                symbol=raw["symbol"], note=raw["note"],
            )
        )
    return entries


def apply_baseline(
    findings: Sequence[Finding], entries: Sequence[BaselineEntry]
) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Split findings into (new, suppressed); also return stale entries."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    used = [False] * len(entries)
    for f in findings:
        hit = None
        for i, e in enumerate(entries):
            if e.matches(f):
                hit = i
                break
        if hit is None:
            new.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return new, suppressed, stale
