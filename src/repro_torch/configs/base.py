"""Model configuration for the port: the decoder-only subset of the
reference's config system.

A :class:`ModelConfig` carries the same fields, defaults and derived
sizes as the reference's, for the block kinds this package implements
(global and sliding-window attention, Mamba-2 SSD, RG-LRU); ``reduced``
and ``scaled`` give the same shapes the reference gives, so a port model
and a reference model built from the same arguments hold the same
parameters.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block parameters."""
    lru_width: Optional[int] = None  # default: d_model
    conv_width: int = 4
    c_exponent: float = 8.0

    def width(self, d_model: int) -> int:
        return self.lru_width or d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid (the families this package implements)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # Superblock pattern of block kinds; layers = pattern repeated + tail.
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
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
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

    @property
    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds: pattern repeated with the remainder as a tail."""
        reps = self.n_layers // len(self.pattern)
        tail = self.n_layers - reps * len(self.pattern)
        return self.pattern * reps + self.pattern[:tail]

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_layers - self.n_superblocks * len(self.pattern)]

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        pat = len(self.pattern)
        n_layers = max(2 * pat, pat + 1) if pat > 1 else 2
        cfg = replace(
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
        if self.ssm is not None:
            cfg = replace(cfg, ssm=SSMConfig(d_state=16, head_dim=16,
                                             chunk_size=32))
        if self.rglru is not None:
            cfg = replace(cfg, rglru=RGLRUConfig(lru_width=128))
        return cfg

    def scaled(self, width_mult: float, depth_mult: float = 1.0,
               name: str = "") -> "ModelConfig":
        """Scale width/depth — used to build ModiPick accuracy/latency pools.
        As in the reference, neither ``ssm.head_dim`` nor
        ``rglru.lru_width`` is scaled."""
        d_model = _ceil_to(int(self.d_model * width_mult), 64)
        return replace(
            self,
            name=name or f"{self.name}-x{width_mult:g}",
            d_model=d_model,
            n_layers=max(len(self.pattern), int(self.n_layers * depth_mult)),
            d_ff=_ceil_to(int(self.d_ff * width_mult), 64),
            head_dim=max(16, _ceil_to(int(self.resolved_head_dim * width_mult), 16)),
        )
