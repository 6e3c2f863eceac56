"""Frozen sweep-spec facade over the round engine.

:class:`SweepSpec` carries the cases and every sweep-level knob,
validates the bundle once and runs through :func:`simulate` on a
device. Only single-round sweeps are ported: a ``schedule`` (timeline),
tenant ``jobs`` and a ``collector`` raise ``NotImplementedError`` naming
the ROADMAP item that adds them. ``backend="jit"`` runs each phase in
one call (the fused phase kernel on a card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch._device import DEFAULT_DEVICE
from repro_torch.net.engine import (
    _BACKENDS,
    SweepCase,
    _not_ported,
    _round_sweep,
    _sweep_topology,
)
from repro_torch.net.sim import PONConfig

__all__ = ["SweepSpec", "simulate"]

_POLICIES = ("fcfs", "bs")


@dataclass(frozen=True)
class SweepSpec:
    """One immutable single-round sweep: cases + knobs.

    ``pon`` is the :class:`PONConfig` (``None`` = the defaults, or the
    config passed to :func:`simulate`). ``ul_deadline_s`` and
    ``ul_outage_s`` are the round's upload deadline and outage windows
    (see ``engine._round_sweep``). ``backend`` is ``None``/``"numpy"``
    (the per-cycle loop) or ``"jit"`` (each phase in one call).
    ``schedule`` mirrors the reference's field; only ``None`` runs.
    """

    cases: Tuple[SweepCase, ...] = field(default_factory=tuple)
    pon: Optional[PONConfig] = None
    schedule: Optional[object] = None
    t_round_hint: float = 10.0
    max_t: float = 600.0
    ul_deadline_s: Optional[object] = None
    ul_outage_s: Optional[object] = None
    backend: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "cases", tuple(self.cases))

    def validate(self) -> "SweepSpec":
        """Check the whole bundle; returns ``self`` for chaining."""
        if not self.cases:
            raise ValueError("SweepSpec needs at least one case")
        if self.schedule is not None:
            raise _not_ported("schedule")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        for b, case in enumerate(self.cases):
            if not isinstance(case, SweepCase):
                raise TypeError(
                    f"cases[{b}] must be a SweepCase; "
                    f"got {type(case).__name__}"
                )
            if case.policy not in _POLICIES:
                raise ValueError(
                    f"cases[{b}]: unknown policy {case.policy!r}; "
                    f"have {_POLICIES}"
                )
            if case.jobs is not None:
                raise _not_ported("jobs")
        _sweep_topology(list(self.cases))
        if self.pon is not None and not isinstance(self.pon, PONConfig):
            raise TypeError("pon must be a repro_torch.net.PONConfig or "
                            "None")
        return self


def simulate(spec: SweepSpec, cfg: Optional[PONConfig] = None,
             collector=None, *, device=DEFAULT_DEVICE):
    """Run a validated :class:`SweepSpec` on ``device``; returns
    ``List[RoundResult]``. ``cfg`` overrides ``spec.pon``; with neither,
    the default :class:`PONConfig` runs."""
    if not isinstance(spec, SweepSpec):
        raise TypeError(
            f"simulate takes a SweepSpec; got {type(spec).__name__}"
        )
    if collector is not None:
        raise _not_ported("collector")
    spec.validate()
    pon = cfg if cfg is not None else (
        spec.pon if spec.pon is not None else PONConfig()
    )
    return _round_sweep(
        pon, list(spec.cases), t_round_hint=spec.t_round_hint,
        max_t=spec.max_t, ul_deadline_s=spec.ul_deadline_s,
        ul_outage_s=spec.ul_outage_s, backend=spec.backend, device=device,
    )
