"""Batched serving on one device: prefill, then decode.

    python -m repro_torch.launch.serve --arch olmo-1b            # smoke, card
    python -m repro_torch.launch.serve --device cpu              # plain path
    python -m repro_torch.launch.serve --full --prompt-len 2048  # full width
    python -m repro_torch.launch.serve --log-jsonl events.jsonl  # + JSONL
    python -m repro_torch.launch.serve --arch mixtral-8x22b --device cpu

``--arch`` takes every registered config (``configs.list_architectures``).

The counterpart of the reference package's ``launch/serve.py``: random
parameters and prompts, a prefill that fills the KV caches, then one
token at a time. Parameters come from a ``torch.Generator`` seeded with
``seed`` and prompts from one seeded with ``seed + 1``, as the reference
seeds its ``jax.random`` keys; the two frameworks draw different bits
from the same seed, so the tokens differ from the reference's (the tests
carry the reference's weights across instead, ``models/convert.py``).
A config with a frontend (pixtral-12b's vision stub, musicgen-large's
audio stub) gets random frontend embeddings, as the reference draws
them, put before the prompt.

The reference sizes the cache as ``prompt_len + max_new_tokens + 8``
and leaves out the frontend tokens that the prefill puts before the
prompt, so a frontend model's cache has fewer slots than the prefill
has tokens (ROADMAP caveat C9); the port counts them
(:func:`cache_len`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import get_config, list_architectures
from repro_torch.dist import stepfns
from repro_torch.models import lm
from repro_torch.models.layers import torch_dtype
from repro_torch.obs import EventLog


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cache_len(cfg, prompt_len: int, max_new_tokens: int) -> int:
    """Positions of the serving cache: the frontend tokens, the prompt,
    the new tokens and 8 spare."""
    return cfg.n_frontend_tokens + prompt_len + max_new_tokens + 8


def frontend_embeds(cfg, batch: int, generator: torch.Generator):
    """The stub frontend's embeddings ``(batch, n_frontend_tokens,
    d_model)`` in ``cfg.dtype``, standard normal from ``generator`` (on
    its device); None for a config without a frontend."""
    if not cfg.frontend:
        return None
    return torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                       generator=generator, device=generator.device,
                       dtype=torch_dtype(cfg.dtype))


def serve(
    arch: str = "olmo-1b",
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    max_new_tokens: int = 16,
    temperature: float = 0.0,
    seed: int = 0,
    log_jsonl=None,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Serve ``batch`` random prompts; returns the generated tokens
    ``(batch, max_new_tokens)`` int64 and prints one echo line.

    Greedy (``argmax``) at ``temperature == 0``, else sampled from the
    tempered softmax with the parameter generator, which also draws a
    frontend's embeddings after the parameters. The cache holds
    :func:`cache_len` positions. The echo line is the
    console view of one ``serve`` event (``obs.EventLog``), which
    ``log_jsonl`` also appends to that file as a JSON line. The times are
    taken after the device has finished the work.
    """
    dev = resolve_device(device)
    log = EventLog(jsonl_path=log_jsonl)
    cfg = get_config(arch, smoke=smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        params = lm.init_params(cfg, gen, dev)
        prefill_step = stepfns.make_prefill_step(cfg)
        decode_step = stepfns.make_decode_step(cfg)
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len),
            generator=torch.Generator(device=dev).manual_seed(seed + 1),
            device=dev)
        extra = frontend_embeds(cfg, batch, gen)
        cache = lm.init_cache(cfg, batch,
                              cache_len(cfg, prompt_len, max_new_tokens),
                              device=dev)

        def pick(logits):
            if temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / temperature, -1)
                return torch.multinomial(probs, 1, generator=gen)
            return torch.argmax(logits[:, -1:], dim=-1)

        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, prompts, cache, extra)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        generated = [tok]
        t1 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits, cache = decode_step(params, tok, cache)
            tok = pick(logits)
            generated.append(tok)
        out = torch.cat(generated, dim=1)
        _sync(dev)
        decode_s = time.perf_counter() - t1
    tps = batch * max_new_tokens / max(decode_s, 1e-9)
    log.emit(
        "serve",
        echo="{arch}: prefill({batch}x{prompt_len})={prefill_ms:.1f}ms "
             "decode {new_tokens} steps={decode_ms:.1f}ms "
             "({tps:.1f} tok/s batched)",
        arch=arch, batch=batch, prompt_len=prompt_len,
        prefill_ms=prefill_s * 1e3, new_tokens=max_new_tokens,
        decode_ms=decode_s * 1e3, tps=tps,
    )
    log.close()
    return out.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    help="a registered config: "
                         + ", ".join(list_architectures()))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--log-jsonl", default=None,
                    help="write structured JSONL events to this path")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the full-width config instead of the smoke one")
    args = ap.parse_args(argv)
    serve(
        arch=args.arch, smoke=not args.full, batch=args.batch,
        prompt_len=args.prompt_len, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, log_jsonl=args.log_jsonl, device=args.device,
    )


if __name__ == "__main__":
    main()
