"""Data substrate: synthetic tasks and federated partitioning (numpy).

The LM input pipeline (the reference's ``data/pipeline.py``) comes with
the LM training path.
"""
from repro_torch.data.federated import (
    build_federated_cnn_clients,
    partition_tokens,
)
from repro_torch.data.synthetic import femnist_like, lm_tokens
