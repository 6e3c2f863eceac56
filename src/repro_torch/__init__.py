"""PyTorch/CUDA port of the bandwidth-slicing FL co-simulation.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core``, ``net``, ``configs``, ``models``, ``dist``, ``launch``,
``kernels/<name>``) and never imports it.
Hand-written Hopper (sm_90a) kernels live in ``csrc/`` and are built at
first CUDA use (``_cuda.py``). Entry points run on ``device="cuda"``
unless the caller asks for the CPU; see ``_device.py``.
"""
