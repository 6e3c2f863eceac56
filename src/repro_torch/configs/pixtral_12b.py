"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo backbone.

40L d_model=5120 32H (GQA kv=8, d_head=128) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (B, 256, d_model) prepended to token embeddings.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig


@register
def pixtral_12b() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=131072,
        pattern=(LayerSpec(ATTN),),
        rope_theta=1_000_000.0,
        frontend="vision",
        n_frontend_tokens=256,
        grad_accum=8,
    )
