"""Architecture configs of the port — one module per ported architecture.

``get_config(name)`` returns the full-size config; ``get_config(name,
smoke=True)`` the reduced same-family config for CPU tests. Only the
ten architectures of the reference package are registered.
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    ATTN,
    RGLRU,
    SHAPES_BY_NAME,
    SSD,
    InputShape,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    RecurrentConfig,
    SSMConfig,
    applicable_shapes,
    param_count,
)

_REGISTRY = {}


def register(fn):
    _REGISTRY[fn.__name__] = fn
    return fn


def _load_all():
    # import side-effect registers each arch
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        gemma3_12b,
        llama3_8b,
        mamba2_780m,
        mixtral_8x22b,
        musicgen_large,
        olmo_1b,
        pixtral_12b,
        qwen3_14b,
        recurrentgemma_2b,
    )


def list_architectures():
    _load_all()
    return sorted(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _load_all()
    key = name.replace("-", "_")
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown architecture {name!r}; the port has {sorted(_REGISTRY)}"
        )
    cfg = _REGISTRY[key]()
    return cfg.smoke() if smoke else cfg
