"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128, expand=2, head 64.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs import register
from repro_torch.configs.base import SSD, LayerSpec, ModelConfig, SSMConfig


@register
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=1,          # unused (attention-free)
        n_kv_heads=1,
        d_head=64,
        d_ff=0,
        vocab_size=50280,
        pattern=(LayerSpec(SSD),),
        ssm=SSMConfig(d_state=128, expand=2, d_head=64, d_conv=4, chunk=128),
        use_rope=False,
        tie_embeddings=True,
        grad_accum=1,
    )
