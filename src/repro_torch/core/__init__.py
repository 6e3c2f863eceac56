"""Bandwidth slicing, its slot schedule, the round-time model, elastic
membership and the deadline baseline (host Python)."""
from repro_torch.core.deadline import (
    estimated_completion,
    greedy_max_clients,
    select_by_deadline,
)
from repro_torch.core.membership import MembershipEvent, SliceManager
from repro_torch.core.round_model import (
    RoundTiming,
    bs_round_time,
    download_time,
    heterogeneous_compute_times,
)
from repro_torch.core.scheduler import (
    CycleGrant,
    SlotAssignment,
    map_to_polling_cycles,
    schedule_makespan,
    schedule_slots,
    slots_to_arrays,
    validate_schedule,
)
from repro_torch.core.slicing import (
    ClientProfile,
    SliceSpec,
    compute_slice,
    min_round_time,
    nabla,
    validate_round_deadline,
)
