"""Carry the JAX package's network inputs over into the port's types.

:func:`from_reference` reads attributes only: it duck-types the
reference's ``PONConfig``, ``ClientProfile``, ``FLRoundWorkload``,
``MultiPonTopology``, ``SweepCase``, ``TimelineSchedule``, ``JobSpec``,
``FaultSchedule`` and ``RetryPolicy`` by class name and imports nothing
of that package, so the same inputs can feed both engines. Each is
built from the port's fields. Arrays are copied.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np

from repro_torch.core.slicing import ClientProfile
from repro_torch.faults import FaultSchedule, RetryPolicy
from repro_torch.net.engine import SweepCase
from repro_torch.net.jobs import JobSpec
from repro_torch.net.multi_pon import MultiPonTopology
from repro_torch.net.sim import FLRoundWorkload, PONConfig
from repro_torch.net.timeline import TimelineSchedule

_TYPES = {cls.__name__: cls for cls in (
    PONConfig, ClientProfile, FLRoundWorkload, MultiPonTopology, SweepCase,
    TimelineSchedule, JobSpec, FaultSchedule, RetryPolicy,
)}


def from_reference(obj):
    """The port's counterpart of ``obj``: one of the nine types above,
    or a list/tuple of them; ``None``, numbers, strings and frozensets
    pass through, numpy arrays as copies."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(o) for o in obj)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if obj is None or isinstance(
            obj, (int, float, str, frozenset, np.generic)):
        return obj
    cls = _TYPES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(obj).__name__}")
    return cls(**{f.name: from_reference(getattr(obj, f.name))
                  for f in fields(cls)})
