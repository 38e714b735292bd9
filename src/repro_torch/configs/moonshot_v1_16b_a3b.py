"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6, fine-grained.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163_840,
        pattern=("attn",),
        rope_theta=50_000.0,
        mlp="swiglu",
        norm="rms",
        tie_embeddings=True,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
        quality=0.74,
    )
