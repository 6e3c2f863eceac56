"""RPA006: stream-key disjointness (see ``repro_torch.analysis.registry``).

The checker extracts every Weyl/derivation constant from the anchor
modules into the generated registry and verifies pairwise disjointness,
oddness and range.  An empty extraction while anchor modules are in the
scan set is itself a finding (a rename that silently empties the
registry must not read as "no collisions").
"""

from __future__ import annotations

from typing import Iterator, Sequence

from repro_torch.analysis import registry
from repro_torch.analysis.core import Checker, Finding, ModuleInfo


class StreamKeyChecker(Checker):
    code = "RPA006"
    name = "stream-key-disjointness"
    description = (
        "stream-key Weyl/derivation constants must be pairwise distinct "
        "odd uint32s so no stream class can alias another"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        anchors = [
            m for m in modules
            if m.path.endswith(registry.ANCHOR_SUFFIXES)
        ]
        if not anchors:
            return
        constants = registry.extract_constants(modules)
        if len(constants) < registry.MIN_CONSTANTS:
            names = sorted({c.name for c in constants})
            yield self.finding(
                anchors[0], anchors[0].tree,
                f"stream-key registry extraction found only "
                f"{len(constants)} constants ({names}) across "
                f"{len(anchors)} anchor modules — expected at least "
                f"{registry.MIN_CONSTANTS}; a rename/move must update "
                f"repro_torch.analysis.registry, not silently shrink the "
                f"registry",
            )
        for problem in registry.validate_constants(constants):
            # anchor the finding at the first named constant's location
            target = next(
                (
                    c for c in constants
                    if c.name in problem and f"{c.path}:{c.line}" in problem
                ),
                constants[0] if constants else None,
            )
            yield Finding(
                path=target.path if target else anchors[0].path,
                line=target.line if target else 0,
                col=0,
                code=self.code,
                symbol=target.name if target else "<module>",
                message=problem,
            )
