"""arctic-480b [moe] — Snowflake Arctic dense-MoE hybrid.

35L d_model=7168 56H (GQA kv=8, d_head=128) d_ff=4864 vocab=32000,
MoE 128 experts top-2 with a dense residual FFN in parallel.
[hf:Snowflake/snowflake-arctic-base; hf]

Memory note: 480B params force FSDP-style param sharding over the data axis
and bf16 optimizer moments to fit 16 GB/chip on a 256-chip pod (see
EXPERIMENTS.md §Perf for the sizing math).
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, MoEConfig


@register
def arctic_480b() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=4864,
        vocab_size=32000,
        pattern=(LayerSpec(ATTN),),
        moe=MoEConfig(
            n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True
        ),
        fsdp=True,
        param_dtype="bfloat16",     # 480B fp32 params cannot fit 16 GB/chip
        kv_cache_dtype="int8",      # 6 TB bf16 KV cache > HBM at decode_32k
        opt_state_dtype="bfloat16",
        remat="full",
        grad_accum=8,
    )
