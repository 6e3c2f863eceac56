"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8, d_head=128) d_ff=16384 vocab=32768.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, MoEConfig

SWA_WINDOW = 4096


@register
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab_size=32768,
        pattern=(LayerSpec(ATTN, window=SWA_WINDOW),),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
        rope_theta=1_000_000.0,
        fsdp=True,
        remat="full",
        grad_accum=8,
    )
