"""The cycle engine's grant primitives.

``kernel.py`` is the Hopper waterfill kernel, ``ref.py`` the plain
PyTorch versions, ``ops.py`` the dispatch (kernel on CUDA, ref on CPU).
"""
from repro_torch.kernels.ponsim.ops import waterfill_grants
from repro_torch.kernels.ponsim.ref import (
    cps_waterfill_ref,
    waterfill_grants_ref,
)
