"""Bandwidth slicing, its slot schedule and the deadline baseline (host
Python)."""
from repro_torch.core.deadline import (
    estimated_completion,
    greedy_max_clients,
    select_by_deadline,
)
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
