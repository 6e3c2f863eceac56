"""Optimizer substrate: AdamW, momentum and SGD on parameter trees, and
the learning-rate schedules."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptimizerConfig,
    OptState,
    apply_updates,
    init_opt_state,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    inverse_sqrt,
    warmup_cosine,
)
