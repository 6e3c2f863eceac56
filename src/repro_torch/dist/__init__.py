"""Step functions of the port: training on one pod and on a pod axis,
the federated FedAvg and FedBuff rounds (``fedops``), and serving."""
from repro_torch.dist import fedops, stepfns  # noqa: F401
from repro_torch.dist.stepfns import (  # noqa: F401
    AsyncRoundState,
    TrainState,
    fed_update_bits,
    init_async_state,
    init_fed_state,
    init_train_state,
    make_async_round_step,
    make_decode_step,
    make_fed_round_step,
    make_fed_train_step,
    make_prefill_step,
    make_train_step,
)
