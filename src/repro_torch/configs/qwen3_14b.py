"""qwen3-14b [dense] — GQA with qk-norm.

40L d_model=5120 40H (GQA kv=8, d_head=128) d_ff=17408 vocab=151936.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig


@register
def qwen3_14b() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=17408,
        vocab_size=151936,
        pattern=(LayerSpec(ATTN),),
        qk_norm=True,
        rope_theta=1_000_000.0,
        grad_accum=8,
    )
