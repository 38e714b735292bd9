"""Model configuration for the port: the dense decoder subset of the
reference's config system.

A :class:`ModelConfig` carries the same fields, defaults and derived
sizes as the reference's, for the block kinds this package implements
(dense attention decoders); ``reduced`` and ``scaled`` give the same
shapes the reference gives, so a port model and a reference model built
from the same arguments hold the same parameters.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the only family this package implements)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # Layer pattern; every layer of a dense decoder is "attn".
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 1024  # sliding window for "local" blocks
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rms"
    tie_embeddings: bool = True
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bf16"
    # Accuracy proxy used by ModiPick pools (top-1-style score in [0,1]).
    quality: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference pads the same
        way so the table shards evenly)."""
        return _ceil_to(self.vocab_size, 256)

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        pat = len(self.pattern)
        n_layers = max(2 * pat, pat + 1) if pat > 1 else 2
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            window=min(self.window, 64),
        )

    def scaled(self, width_mult: float, depth_mult: float = 1.0,
               name: str = "") -> "ModelConfig":
        """Scale width/depth — used to build ModiPick accuracy/latency pools."""
        d_model = _ceil_to(int(self.d_model * width_mult), 64)
        return replace(
            self,
            name=name or f"{self.name}-x{width_mult:g}",
            d_model=d_model,
            n_layers=max(len(self.pattern), int(self.n_layers * depth_mult)),
            d_ff=_ceil_to(int(self.d_ff * width_mult), 64),
            head_dim=max(16, _ceil_to(int(self.resolved_head_dim * width_mult), 16)),
        )
