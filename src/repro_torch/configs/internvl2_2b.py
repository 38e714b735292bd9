"""internvl2-2b [vlm]: InternViT + InternLM2 backbone; the ViT frontend is a
stub — ``models/api.py`` ``batch_specs`` asks for precomputed patch
embeddings.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553  [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig, VLMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92_553,
        pattern=("attn",),
        rope_theta=1_000_000.0,
        mlp="swiglu",
        norm="rms",
        tie_embeddings=False,
        vlm=VLMConfig(n_image_tokens=256),
        quality=0.64,
    )
