"""llama3-8b [dense] — GQA, 128k vocab.

32L d_model=4096 32H (GQA kv=8, d_head=128) d_ff=14336 vocab=128256.
[arXiv:2407.21783; unverified]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig


@register
def llama3_8b() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="llama3-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=128256,
        pattern=(LayerSpec(ATTN),),
        rope_theta=500_000.0,
        grad_accum=4,
    )
