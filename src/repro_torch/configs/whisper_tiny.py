"""whisper-tiny [audio]: encoder-decoder; the conv frontend is a stub —
``models/api.py`` ``batch_specs`` asks for precomputed frame embeddings.

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865  [arXiv:2212.04356]
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51_865,
        pattern=("attn",),
        use_rope=False,  # whisper: sinusoidal absolute positions
        qkv_bias=True,
        mlp="gelu",
        norm="layer",
        tie_embeddings=True,
        encdec=EncDecConfig(n_encoder_layers=4, n_frames=1500),
        quality=0.50,
    )
