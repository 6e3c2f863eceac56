"""Step functions of the port: serving, and a pod update's wire size.

The counterparts of the reference package's ``dist/stepfns.py`` serving
steps. There they are jitted and lowered onto meshes; here they run
eagerly on one device. :func:`fed_update_bits` sizes one pod's upload
for the co-simulation. The train, federated and async steps come with
the training path (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import fedops
from repro_torch.models import lm


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``step(params, tokens, cache, extra_embeds=None) -> (logits, cache)``."""

    def step(params, tokens, cache, extra_embeds=None):
        return lm.prefill(params, cfg, tokens, cache, extra_embeds)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``step(params, token, cache) -> (logits, cache)`` — one token."""

    def step(params, token, cache):
        return lm.decode_step(params, cfg, token, cache)

    return step


def fed_update_bits(cfg: ModelConfig, compress: Optional[str] = "int8",
                    topk_frac: float = 0.05) -> int:
    """Wire bits of one pod's upload under ``compress`` (``M_i^UD``).

    The parameter tree is built under ``FakeTensorMode`` (shapes and
    dtypes, no storage) and counted by ``repro_torch.fl.compression``'s
    accounting, as the reference counts its ``eval_shape`` tree.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.fl.compression import (
        CompressorConfig,
        compressed_update_bits,
    )

    scheme = fedops.check_scheme(compress)
    with FakeTensorMode():
        params = lm.init_params(cfg, device="cpu")
    comp = CompressorConfig(scheme=scheme, topk_frac=topk_frac)
    return compressed_update_bits(params, comp)
