"""Bandwidth slicing and its slot schedule (host Python)."""
from repro_torch.core.scheduler import (
    SlotAssignment,
    schedule_slots,
    slots_to_arrays,
)
from repro_torch.core.slicing import (
    ClientProfile,
    SliceSpec,
    compute_slice,
)
