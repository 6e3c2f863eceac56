"""Data substrate: synthetic tasks, federated partitioning and the LM
token batcher (numpy)."""
from repro_torch.data.federated import (
    build_federated_cnn_clients,
    partition_tokens,
)
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.data.synthetic import femnist_like, lm_tokens
