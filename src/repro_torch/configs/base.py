"""Configuration for the port: the reference's config system.

A :class:`ModelConfig` carries the same fields, defaults and derived
sizes as the reference's, for the block kinds and feed-forwards this
package implements (global and sliding-window attention, Mamba-2 SSD,
RG-LRU; dense MLPs and mixtures of experts; a whisper-style encoder with
cross-attention, image embeddings before the text; bf16 or int8 KV
caches); ``reduced`` and ``scaled`` give the same shapes the reference
gives, so a port model and a reference model built from the same
arguments hold the same parameters.  :data:`SHAPES` are the reference's
batch shapes, :class:`TrainConfig` its training settings.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Tokens a routing group holds; each expert takes at most its capacity
    # of entries from a group (``models/moe.py``).
    group_size: int = 512


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
class EncDecConfig:
    """Encoder-decoder (whisper) extras; the frontend is a stub that
    provides precomputed frame embeddings."""
    n_encoder_layers: int = 4
    n_frames: int = 1500  # whisper 30s @ 50Hz after conv frontend


@dataclass(frozen=True)
class VLMConfig:
    """VLM extras; the ViT frontend is a stub that provides patch
    embeddings."""
    n_image_tokens: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
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
    use_rope: bool = True  # False → sinusoidal absolute positions at embed
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rms"  # rms | layer
    tie_embeddings: bool = True
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (per-slot-scaled quantized KV)
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

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: at most a quarter of the layers are
        global attention (the reference's rule)."""
        kinds = self.block_kinds
        n_global = sum(1 for k in kinds if k == "attn")
        return n_global == 0 or (n_global / len(kinds)) <= 0.25

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), as the
        reference counts it for the decoders."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        for kind in self.block_kinds:
            if kind in ("attn", "local"):
                n += (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                      + self.n_heads * hd * d)
            elif kind == "ssd":
                s = self.ssm
                di, nh = s.d_inner(d), s.n_heads(d)
                conv_ch = di + 2 * s.n_groups * s.d_state
                n += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                n += conv_ch * s.conv_width + nh + nh  # conv, A_log, D
                n += di * d  # out proj
            elif kind == "rglru":
                w = self.rglru.width(d)
                n += (2 * d * w + w * self.rglru.conv_width + 2 * w * w
                      + 4 * w + w * d)
            if kind != "ssd":  # MLP for every non-ssd block
                if self.moe is not None:
                    e = self.moe
                    n += d * e.n_experts  # router
                    n += e.n_experts * (3 * d * e.d_ff_expert)
                else:  # the reference counts geglu's wi, wg, wo as two
                    mults = 3 if self.mlp == "swiglu" else 2
                    n += mults * d * self.d_ff
            n += 2 * d  # two norms
        if self.encdec is not None:
            attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                    + self.n_heads * hd * d)
            enc_block = attn + (3 if self.mlp == "swiglu" else 2) \
                * d * self.d_ff + 2 * d
            n += self.encdec.n_encoder_layers * enc_block
            # decoder cross-attention per layer (the reference counts its
            # q, k, v, o and one norm, as it holds them)
            n += self.n_layers * (attn + d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        per_layer_delta = (e.n_experts - e.top_k) * 3 * self.d_model \
            * e.d_ff_expert
        n_moe_layers = sum(1 for k in self.block_kinds if k != "ssd")
        return self.param_count() - n_moe_layers * per_layer_delta

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
        if self.moe is not None:
            cfg = replace(cfg, moe=MoEConfig(n_experts=4, top_k=2,
                                             d_ff_expert=64, group_size=32))
        if self.ssm is not None:
            cfg = replace(cfg, ssm=SSMConfig(d_state=16, head_dim=16,
                                             chunk_size=32))
        if self.rglru is not None:
            cfg = replace(cfg, rglru=RGLRUConfig(lru_width=128))
        if self.encdec is not None:
            cfg = replace(cfg, encdec=EncDecConfig(n_encoder_layers=2,
                                                   n_frames=64))
        if self.vlm is not None:
            cfg = replace(cfg, vlm=VLMConfig(n_image_tokens=16))
        return cfg

    def with_padded_heads(self, multiple: int) -> "ModelConfig":
        """Pad query heads up to a multiple so attention head-shards over a
        TP axis that doesn't divide the native head count (the same trick
        as vocab padding: spend a little extra compute to unlock even
        sharding).  KV heads are left as-is (small, replicated)."""
        padded = _ceil_to(self.n_heads, multiple)
        if padded == self.n_heads or padded > self.n_heads * 1.34:
            # only worth it when the extra attention FLOPs stay ≤ ~1/3
            # (qwen2 12→16, phi4 24→32; not whisper 6→16 or rg 10→16)
            return self
        return replace(self, n_heads=padded, head_dim=self.resolved_head_dim,
                       name=self.name + f"-hpad{padded}")

    def scaled(self, width_mult: float, depth_mult: float = 1.0,
               name: str = "") -> "ModelConfig":
        """Scale width/depth — used to build ModiPick accuracy/latency pools.
        As in the reference, none of ``ssm.head_dim``,
        ``rglru.lru_width`` and ``moe.d_ff_expert`` is scaled."""
        d_model = _ceil_to(int(self.d_model * width_mult), 64)
        return replace(
            self,
            name=name or f"{self.name}-x{width_mult:g}",
            d_model=d_model,
            n_layers=max(len(self.pattern), int(self.n_layers * depth_mult)),
            d_ff=_ceil_to(int(self.d_ff * width_mult), 64),
            head_dim=max(16, _ceil_to(int(self.resolved_head_dim * width_mult), 16)),
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """The reference's training settings, field for field with the same
    defaults.  ``remat`` other than ``"none"`` recomputes each
    superblock in the backward pass; ``compress_grads`` is carried and
    read by nothing, as in the reference."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"  # cosine | linear | constant
    remat: str = "full"  # none | full | dots
    grad_accum: int = 1
    opt_moments: str = "fp32"  # fp32 | int8 (8-bit Adam moments)
    compress_grads: bool = False  # int8 + error-feedback all-reduce
    seed: int = 0
