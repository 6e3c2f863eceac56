"""gemma3-12b [dense] — 5 local : 1 global attention interleave, 128k context.

48L d_model=3840 16H (GQA kv=8, d_head=256) d_ff=15360 vocab=262144.
Pattern unit: 5×local(w=1024) + 1×global; 48 = 8 units.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig

LOCAL_WINDOW = 1024


@register
def gemma3_12b() -> ModelConfig:
    local = LayerSpec(ATTN, window=LOCAL_WINDOW)
    return ModelConfig(
        attn_impl="chunked",
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_head=256,
        d_ff=15360,
        vocab_size=262144,
        pattern=(local, local, local, local, local, LayerSpec(ATTN)),
        qk_norm=True,
        embed_scale=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        grad_accum=8,
    )
