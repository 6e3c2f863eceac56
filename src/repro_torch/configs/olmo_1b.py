"""olmo-1b [dense] — MHA with non-parametric LayerNorm.

16L d_model=2048 16H (kv=16 -> MHA, d_head=128) d_ff=8192 vocab=50304.
[arXiv:2402.00838; hf]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig


@register
def olmo_1b() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=8192,
        vocab_size=50304,
        pattern=(LayerSpec(ATTN),),
        norm="layernorm_nonparam",
        tie_embeddings=True,
        grad_accum=2,
    )
