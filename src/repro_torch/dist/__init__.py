"""Distribution layer of the port: the partition rules of the ``("pod",
"data", "model")`` mesh (``sharding``: specs from path names and shapes,
DTensor placements), and the step functions (``stepfns``) that train on
one pod and on a pod axis, on plain tensors or on a ``DeviceMesh``, the
federated FedAvg and FedBuff rounds (``fedops``), and serving."""
from repro_torch.dist import fedops, sharding, stepfns  # noqa: F401
from repro_torch.dist.sharding import (  # noqa: F401
    batch_spec,
    cache_specs,
    opt_moment_specs,
    param_spec,
    param_specs,
)
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
