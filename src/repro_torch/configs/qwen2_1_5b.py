"""qwen2-1.5b [dense]: GQA with QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936  [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151_936,
        pattern=("attn",),
        rope_theta=1_000_000.0,
        qkv_bias=True,
        mlp="swiglu",
        norm="rms",
        tie_embeddings=True,
        quality=0.62,
    )
