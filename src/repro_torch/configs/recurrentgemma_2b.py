"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention, 1 attn : 2 rec.

26L d_model=2560 10H (MQA kv=1, d_head=256) d_ff=7680 vocab=256000.
Pattern unit (rec, rec, local-attn w=2048); 26 = 8 units + 2 remainder rec.
[arXiv:2402.19427; hf]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (
    ATTN,
    RGLRU,
    LayerSpec,
    ModelConfig,
    RecurrentConfig,
)


@register
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        attn_impl="chunked",
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_head=256,
        d_ff=7680,
        vocab_size=256000,
        pattern=(LayerSpec(RGLRU), LayerSpec(RGLRU), LayerSpec(ATTN, window=2048)),
        recurrent=RecurrentConfig(rnn_width=2560),
        embed_scale=True,
        grad_accum=2,
    )
