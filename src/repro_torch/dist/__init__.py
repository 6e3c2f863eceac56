"""Step functions of the port: the single-pod train step and serving."""
from repro_torch.dist.stepfns import (  # noqa: F401
    TrainState,
    fed_update_bits,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
