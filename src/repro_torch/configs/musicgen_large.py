"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32 -> MHA, d_head=64) d_ff=8192 vocab=2048.
[arXiv:2306.05284; hf]

Backbone only per the assignment: the EnCodec frontend is a STUB —
``input_specs()`` supplies precomputed conditioning frame embeddings
(B, 64, d_model) prepended to the codec-token stream. GELU MLP + additive
sinusoidal positions (the MusicGen transformer), no RoPE.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig


@register
def musicgen_large() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab_size=2048,
        pattern=(LayerSpec(ATTN),),
        mlp_act="gelu",
        use_rope=False,
        abs_sinusoidal=True,
        norm="layernorm",
        frontend="audio",
        n_frontend_tokens=64,
        grad_accum=4,
    )
