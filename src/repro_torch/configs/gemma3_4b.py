"""gemma3-4b [dense]: 5 local : 1 global attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144  [hf:google/gemma-3]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10_240,
        vocab_size=262_144,
        # 5:1 local:global superblocks; 34 = 5 superblocks of 6 + 4 local tail
        pattern=("local", "local", "local", "local", "local", "attn"),
        window=1024,
        rope_theta=1_000_000.0,
        mlp="geglu",
        norm="rms",
        embed_scale=True,
        tie_embeddings=True,
        quality=0.70,
    )
