"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 rglru.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000  [arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        pattern=("rglru", "rglru", "local"),
        window=2048,
        mlp="geglu",
        norm="rms",
        embed_scale=True,
        tie_embeddings=True,
        rglru=RGLRUConfig(lru_width=2560, conv_width=4),
        quality=0.60,
    )
