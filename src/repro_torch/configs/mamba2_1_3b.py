"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.

48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,       # unused (attention-free)
        n_kv_heads=1,    # unused
        d_ff=0,          # SSD blocks have no separate MLP (mamba2 style)
        vocab_size=50_280,
        pattern=("ssd",),
        norm="rms",
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256, conv_width=4),
        quality=0.55,
    )
