"""command-r-35b [dense]: GQA, no-bias, LayerNorm.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22_528,
        vocab_size=256_000,
        pattern=("attn",),
        rope_theta=8_000_000.0,
        mlp="swiglu",
        norm="layer",
        tie_embeddings=True,
        quality=0.80,
    )
