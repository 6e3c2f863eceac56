"""Mamba-2 SSD scan (state-space duality).

``kernel.py`` is the Hopper kernel K5, ``ref.py`` the plain PyTorch
versions (the token recurrence and the chunked algorithm), ``ops.py``
the dispatch (kernel on CUDA, chunked plain version on CPU).
"""
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_scan_ref
