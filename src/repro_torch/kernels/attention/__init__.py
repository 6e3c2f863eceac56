"""Flash-attention forward (causal / sliding-window / GQA).

``kernel.py`` is the Hopper kernel K4, ``ref.py`` the plain PyTorch
version, ``ops.py`` the dispatch (kernel on CUDA, ref on CPU).
"""
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.attention.ref import attention_ref
