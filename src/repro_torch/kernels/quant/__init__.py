"""Blockwise symmetric int8 quantisation (the ``M_i^UD`` payload lever).

``kernel.py`` is the Hopper kernel pair K3 (quantise) and K3'
(dequantise), ``ref.py`` the plain PyTorch versions, ``ops.py`` the
dispatch (kernels on CUDA, plain versions on CPU).
"""
from repro_torch.kernels.quant.ops import (
    dequantize_int8,
    quantize_int8,
    roundtrip,
)
from repro_torch.kernels.quant.ref import (
    dequantize_int8_ref,
    quantize_int8_ref,
    roundtrip_ref,
)
