"""RG-LRU linear scan (Griffin's diagonal recurrence).

``kernel.py`` is the Hopper kernel K6, ``ref.py`` the plain PyTorch
version, ``ops.py`` the dispatch (kernel on CUDA, plain version on CPU).
"""
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref
