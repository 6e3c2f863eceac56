"""Concrete RPA rule modules; importing this package registers them all."""

from repro_torch.analysis.checkers import (  # noqa: F401
    collector,
    determinism,
    kernel_triple,
    stream_keys,
    tracer,
    x64,
)
