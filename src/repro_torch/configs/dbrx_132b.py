"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352
[hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10_752,
        vocab_size=100_352,
        pattern=("attn",),
        rope_theta=500_000.0,
        mlp="swiglu",
        norm="layer",
        tie_embeddings=False,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10_752),
        quality=0.82,
    )
