"""Stream-key derivation-constant registry (RPA006 backing store).

Every stream class in the port derives its threefry keys by
Weyl-shifting with module-level constants, the JAX package's own values:

* ``kernels/traffic/ref.py``   — ``KEY_WEYL_*`` (per-draw derived keys);
* ``kernels/traffic/ops.py``   — ``_PON_WEYL_*`` / ``_JOB_WEYL_*``
  (``make_stream_key``'s pon/job axes);
* ``faults/streams.py``        — ``_CLASS_WEYL_*`` / ``_CASE_WEYL``
  (fault-class streams).

The no-aliasing contract requires all of them to be pairwise distinct:
a new stream class reusing a constant would let two logically
independent streams collide for some ``(seed, index)`` combination.
This module extracts the constants from source by AST (no imports: the
registry works without torch or numpy and cannot observe a stale
installed copy) so the analysis pass, ``--dump-registry`` and the tests
all see the same generated view.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.analysis.core import ModuleInfo

#: module-path suffixes that may define stream-key constants
ANCHOR_SUFFIXES = (
    "repro_torch/kernels/traffic/ref.py",
    "repro_torch/kernels/traffic/ops.py",
    "repro_torch/faults/streams.py",
)

#: a shrinking anchor set is a wiring error, not a pass: today the three
#: anchors define 10 constants (``KEY_WEYL_0/1`` and ``_C240``, the four
#: ``_PON/_JOB_WEYL_*``, ``_CLASS_WEYL_0/1`` and ``_CASE_WEYL``)
MIN_CONSTANTS = 10

_MASK32 = 0xFFFFFFFF


@dataclass(frozen=True, order=True)
class StreamConstant:
    path: str
    name: str
    value: int
    line: int

    @property
    def is_weyl(self) -> bool:
        """Weyl increments must be odd (an even shift is non-injective
        mod 2^32); non-Weyl derivation constants (``_C240``) are exempt."""
        return "WEYL" in self.name


def _is_constant_name(name: str) -> bool:
    return "WEYL" in name or name in ("_C240", "_CASE_WEYL")


def extract_constants(modules: Sequence[ModuleInfo]) -> List[StreamConstant]:
    """All stream-key constants defined by anchor modules in the scan set."""
    out: List[StreamConstant] = []
    for mod in modules:
        if not mod.path.endswith(ANCHOR_SUFFIXES):
            continue
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if not (
                    isinstance(target, ast.Name)
                    and _is_constant_name(target.id)
                ):
                    continue
                if isinstance(node.value, ast.Constant) and isinstance(
                    node.value.value, int
                ):
                    out.append(
                        StreamConstant(
                            path=mod.path, name=target.id,
                            value=node.value.value, line=node.lineno,
                        )
                    )
    return sorted(out)


def validate_constants(
    constants: Sequence[StreamConstant],
) -> List[str]:
    """Disjointness / range / parity violations, as human-readable strings
    (RPA006 wraps them into findings)."""
    problems: List[str] = []
    by_value: dict = {}
    for c in constants:
        if not 0 < c.value <= _MASK32:
            problems.append(
                f"{c.name} ({c.path}:{c.line}) = {c.value:#x} is outside "
                f"(0, 2^32] — not a valid uint32 derivation constant"
            )
        if c.is_weyl and c.value % 2 == 0:
            problems.append(
                f"{c.name} ({c.path}:{c.line}) = {c.value:#x} is even — a "
                f"Weyl increment must be odd to stay injective mod 2^32"
            )
        by_value.setdefault(c.value, []).append(c)
    for value, cs in sorted(by_value.items()):
        if len(cs) > 1:
            names = ", ".join(f"{c.name} ({c.path}:{c.line})" for c in cs)
            problems.append(
                f"duplicate derivation constant {value:#x}: {names} — "
                f"streams derived through these constants can alias "
                f"(the stream-key disjointness contract)"
            )
    return problems


def registry_payload(modules: Sequence[ModuleInfo]) -> dict:
    """JSON-friendly generated registry (``--dump-registry``)."""
    constants = extract_constants(modules)
    return {
        "constants": [
            {
                "name": c.name,
                "value": f"{c.value:#010x}",
                "path": c.path,
                "line": c.line,
                "weyl": c.is_weyl,
            }
            for c in constants
        ],
        "problems": validate_constants(constants),
    }
