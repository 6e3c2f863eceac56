"""Step functions of the port: serving only so far.

The counterparts of the reference package's ``dist/stepfns.py`` serving
steps. There they are jitted and lowered onto meshes; here they run
eagerly on one device. The train, federated and async steps come with
the training path (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
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
