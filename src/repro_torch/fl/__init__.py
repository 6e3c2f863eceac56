"""Federated-learning substrate: server, clients, aggregation, compression
and the FL × PON co-simulation (``FLNetworkCoSim``)."""
from repro_torch.fl.aggregation import (
    FedBuffAggregator,
    fedadam_init,
    fedadam_step,
    fedavg,
    fedavg_delta,
    fedbuff_merge,
    quorum_commit,
    quorum_threshold,
    staleness_scale,
)
from repro_torch.fl.client import Client, LocalTrainConfig
from repro_torch.fl.compression import (
    CompressorConfig,
    compress_delta,
    compressed_update_bits,
    dequantize_int8,
    init_error_state,
    quantize_int8,
    topk_sparsify,
)
from repro_torch.fl.selection import SelectionConfig, select_clients
from repro_torch.fl.server import CPSServer, PendingUpdate, RoundLog
from repro_torch.fl.simulation import CoSimConfig, CoSimResult, FLNetworkCoSim
