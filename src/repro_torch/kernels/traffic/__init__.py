"""Counter-based Poisson-burst traffic sampler (threefry-2x32).

``kernel.py`` is the Hopper kernel, ``ref.py`` the plain PyTorch
version, ``ops.py`` the public dispatch (kernel on CUDA, ref on CPU).
"""
from repro_torch.kernels.traffic.ops import (
    make_stream_key,
    sample_arrival_bits,
)
from repro_torch.kernels.traffic.ref import threefry2x32
