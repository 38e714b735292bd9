"""Model assembly: decoder LMs of attention, local-attention, Mamba-2
SSD and RG-LRU blocks, with dense or mixture-of-experts feed-forwards;
whisper's encoder-decoder and a VLM's image embeddings before the text.

The reference scans over stacked superblocks (one repetition of the
config's block pattern) plus an unrolled tail; here the layers are a
Python list in the order of ``cfg.block_kinds`` and the forward pass a
loop over it.  Parameters are plain dictionaries of tensors:

    {"embed": (Vpad, D), "final_norm": (D,), "lm_head": (D, Vpad) when
     untied, "layers": [one dict per layer], "encoder": {"layers": [...],
     "final_norm": (D,)} for an encoder-decoder}

where an ``attn`` or ``local`` layer is ``{"norm1", "wqkv", ["bqkv"],
"wo", "norm2", "mlp": {"wi", ["wg"], "wo"}}`` (``wqkv`` is the
reference's ``wq | wk | wv`` side by side, ``bqkv`` their biases; a MoE
config's ``mlp`` is ``{"router", "wi", "wg", "wo"}``, see
``models/moe.py``), an
``rglru`` layer ``{"norm1", "rglru", "norm2", "mlp"}`` and an ``ssd``
layer ``{"norm1", "ssd"}`` (no MLP; see ``models/ssm.py`` and
``models/rglru.py``).  In an encoder-decoder every ``attn`` layer of the
decoder is an ``xdec`` layer (the reference's ``decoder_kind``): an
``attn`` layer with ``"norm_x"`` and ``"xattn": {"wq", ["bq"], "wkv",
["bkv"], "wo"}`` (``wkv``: ``wk | wv``) for cross-attention over the
encoder output; the encoder's layers are ``attn`` layers with a dense
MLP, run without a mask.  A cache is a list with one entry per layer: a
``{"k", "v"}`` (B, C, KV, hd) pair for attention (int8 with ``"k_scale"``
and ``"v_scale"`` (B, C, KV) fp32 under ``kv_cache_dtype="int8"``; an
``xdec`` layer adds the cross cache ``"xk"``, ``"xv"`` (B, F, KV, hd)),
the conv history and recurrent state for ``ssd`` and ``rglru``.

``prefill`` takes the reference's batch dict: ``{"tokens"}``, with
``"frames"`` (B, F, D) for an encoder-decoder or ``"image_embeds"``
(B, n_img, D) for a VLM, whose positions then run over ``n_img + S``
(a decode step's ``pos`` continues from there).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KERNELS, ModelKernels
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, init_normal, mlp_apply,
                                       rope_tables, sinusoidal_pos)

Params = Dict[str, Any]
ATTENTION_KINDS = ("attn", "local", "xdec")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a malformed configuration: an unknown family, block
    kind, norm, MLP or KV-cache type, or a family or block kind without
    its sub-config."""
    unsupported = []
    if cfg.family not in FAMILIES or not set(
            cfg.pattern) <= {"attn", "local", "ssd", "rglru"}:
        unsupported.append(f"family {cfg.family!r} / pattern {cfg.pattern}")
    for family, sub, name in (("moe", cfg.moe, "MoEConfig"),
                              ("encdec", cfg.encdec, "EncDecConfig"),
                              ("vlm", cfg.vlm, "VLMConfig")):
        if cfg.family == family and sub is None:
            unsupported.append(f"family {family!r} without a {name}")
    if "ssd" in cfg.pattern and cfg.ssm is None:
        unsupported.append("ssd blocks without an SSMConfig")
    if "rglru" in cfg.pattern and cfg.rglru is None:
        unsupported.append("rglru blocks without an RGLRUConfig")
    if cfg.norm not in ("rms", "layer"):
        unsupported.append(f"norm {cfg.norm!r}")
    if cfg.kv_cache_dtype not in ("bf16", "int8"):
        unsupported.append(f"kv_cache_dtype {cfg.kv_cache_dtype!r}")
    if cfg.mlp not in ("swiglu", "geglu", "gelu"):
        unsupported.append(f"mlp {cfg.mlp!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not a configuration the port implements: "
            + "; ".join(unsupported))


def decoder_kind(cfg: ModelConfig, kind: str) -> str:
    """An encoder-decoder's ``attn`` layers are ``xdec`` layers."""
    return "xdec" if cfg.encdec is not None and kind == "attn" else kind


def layer_kinds(cfg: ModelConfig):
    """The kind of each decoder layer, in order."""
    return tuple(decoder_kind(cfg, k) for k in cfg.block_kinds)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters from ``generator`` on ``device`` (the card
    unless the caller asks for the CPU); raises when ``generator`` lives
    on another device."""
    check_supported(cfg)
    dev = resolve_device(device)
    gdev = generator.device
    if gdev.type != dev.type or dev.index not in (None, gdev.index):
        raise ValueError(f"the generator lives on {gdev}, but the "
                         f"parameters were asked for on {dev}")
    dev = gdev
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, kv, v = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab

    def normal(*shape, out_proj=False):
        return init_normal(shape, generator, dtype, out_proj=out_proj)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attention_layer():
        # the reference draws wq, wk and wv each with std 1/sqrt(out dim)
        wqkv = torch.cat([normal(d, h * hd), normal(d, kv * hd),
                          normal(d, kv * hd)], dim=1)
        p = {"wqkv": wqkv, "wo": normal(h * hd, d, out_proj=True)}
        if cfg.qkv_bias:
            p["bqkv"] = zeros((h + 2 * kv) * hd)
        return p

    def cross_attention():
        p = {"wq": normal(d, h * hd),
             "wkv": torch.cat([normal(d, kv * hd), normal(d, kv * hd)],
                              dim=1),
             "wo": normal(h * hd, d, out_proj=True)}
        if cfg.qkv_bias:
            p["bq"], p["bkv"] = zeros(h * hd), zeros(2 * kv * hd)
        return p

    def dense_mlp():
        mlp = {"wi": normal(d, f), "wo": normal(f, d, out_proj=True)}
        if cfg.mlp in ("swiglu", "geglu"):
            mlp["wg"] = normal(d, f)
        return mlp

    layers = []
    for kind in layer_kinds(cfg):
        p = {"norm1": zeros(d)}
        if kind == "ssd":
            p["ssd"] = ssm_mod.init_params(cfg, generator, dtype)
            layers.append(p)
            continue
        if kind == "rglru":
            p["rglru"] = rglru_mod.init_params(cfg, generator, dtype)
        else:
            p.update(attention_layer())
        if kind == "xdec":
            p["norm_x"], p["xattn"] = zeros(d), cross_attention()
        p["norm2"] = zeros(d)
        p["mlp"] = (moe_mod.init_params(cfg, generator, dtype)
                    if cfg.moe is not None else dense_mlp())
        layers.append(p)
    params = {"embed": normal(v, d), "layers": layers,
              "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, v)
    if cfg.encdec is not None:
        params["encoder"] = {
            "layers": [dict(norm1=zeros(d), **attention_layer(),
                            norm2=zeros(d), mlp=dense_mlp())
                       for _ in range(cfg.encdec.n_encoder_layers)],
            "final_norm": zeros(d)}
    return params


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16) -> List[dict]:
    """The (shape, dtype) of each tensor of a cache of ``cache_len``
    slots, layer by layer: what ``init_cache`` allocates and a prefill
    returns."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    specs = []
    for kind in layer_kinds(cfg):
        if kind in ATTENTION_KINDS:
            C = min(cache_len, cfg.window) if kind == "local" else cache_len
            if cfg.kv_cache_dtype == "int8":
                c = {"k": ((batch, C, kv, hd), torch.int8),
                     "v": ((batch, C, kv, hd), torch.int8),
                     "k_scale": ((batch, C, kv), torch.float32),
                     "v_scale": ((batch, C, kv), torch.float32)}
            else:
                c = {"k": ((batch, C, kv, hd), dtype),
                     "v": ((batch, C, kv, hd), dtype)}
            if kind == "xdec":
                F = cfg.encdec.n_frames
                c["xk"] = c["xv"] = ((batch, F, kv, hd), dtype)
        elif kind == "ssd":
            s = cfg.ssm
            d_in, n = s.d_inner(cfg.d_model), s.n_groups * s.d_state
            c = {"conv": ((batch, s.conv_width - 1, d_in + 2 * n), dtype),
                 "state": ((batch, s.n_heads(cfg.d_model), s.head_dim,
                            s.d_state), dtype)}
        else:
            w = cfg.rglru.width(cfg.d_model)
            c = {"conv": ((batch, cfg.rglru.conv_width - 1, w), dtype),
                 "h": ((batch, w), dtype)}
        specs.append(c)
    return specs


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[dict]:
    """An empty cache: zeros of the shapes a prefill of ``cache_len``
    slots produces."""
    dev = resolve_device(device)
    return [{key: torch.zeros(shape, dtype=dt, device=dev)
             for key, (shape, dt) in c.items()}
            for c in cache_specs(cfg, batch, cache_len, dtype)]


def embed_tokens(cfg: ModelConfig, params, tokens, positions=None):
    """Token embeddings (scaled by √D where the config says so), plus
    fp32 sinusoidal positions cast to their dtype for a config without
    RoPE when ``positions`` are given.  The lookup is ``F.embedding``,
    whose backward on the card sums a token's rows in a fixed order (an
    indexed read's backward adds them atomically), so a training step
    gives the same bits every run."""
    x = F.embedding(tokens, params["embed"])
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model) ** 0.5, dtype=x.dtype,
                         device=x.device)
    if not cfg.use_rope and positions is not None:
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    return x


def unembed(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def ffn_aux(cfg: ModelConfig, p, x, routing=None):
    """(x + the layer's feed-forward of its second norm, the MoE's Switch
    load-balancing loss or None): the MLP, or the MoE (routed by
    ``routing`` when given, else by its own input)."""
    h2 = apply_norm(cfg.norm, x, p["norm2"], cfg.norm_eps)
    if cfg.moe is not None:
        out, aux = moe_mod.moe_ffn(p["mlp"], h2, cfg, routing)
        return x + out, aux
    return x + mlp_apply(p["mlp"], h2, cfg.mlp), None


def ffn_block(cfg: ModelConfig, p, x, routing=None):
    """x + the layer's feed-forward (:func:`ffn_aux` without the loss)."""
    return ffn_aux(cfg, p, x, routing)[0]


def rope_for(cfg: ModelConfig, positions):
    """RoPE tables at ``positions`` for the attention layers, or None
    when there are none or the config has absolute positions."""
    if not cfg.use_rope or not set(cfg.block_kinds) & set(ATTENTION_KINDS):
        return None
    return rope_tables(positions, cfg.rope_theta, cfg.resolved_head_dim)


def encoder_block(cfg: ModelConfig, p, x, impl: ModelKernels = KERNELS):
    """One encoder layer: unmasked self-attention over the frames (K2
    with ``causal=False``), then the dense MLP.  x: (B,F,D)."""
    h = apply_norm(cfg.norm, x, p["norm1"], cfg.norm_eps)
    out, _ = attn.prefill_attention(p, h, None, cfg, impl=impl,
                                    causal=False)
    x = x + out
    h2 = apply_norm(cfg.norm, x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp)


def encode(cfg: ModelConfig, params, frames, impl: ModelKernels = KERNELS):
    """The whisper encoder over precomputed frame embeddings (B,F,D):
    frames and sinusoidal positions cast to the embedding's dtype, the
    encoder layers, its final norm."""
    dt = params["embed"].dtype
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(dt) + sinusoidal_pos(pos, cfg.d_model).to(dt)
    for p in params["encoder"]["layers"]:
        x = encoder_block(cfg, p, x, impl)
    return apply_norm(cfg.norm, x, params["encoder"]["final_norm"],
                      cfg.norm_eps)


def assemble_input(cfg: ModelConfig, params, batch,
                   impl: ModelKernels = KERNELS):
    """(x (B,S',D), positions (B,S'), encoder output or None) of a batch
    dict: a VLM's image embeddings, cast to the embedding's dtype, go
    before the text (S' = n_img + S); an encoder-decoder's frames are
    encoded."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = None
    if cfg.vlm is not None:
        img = batch["image_embeds"].to(params["embed"].dtype)
        S += img.shape[1]
        x = torch.cat([img, embed_tokens(cfg, params, tokens)], dim=1)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    if cfg.vlm is None:
        if cfg.encdec is not None:
            enc_out = encode(cfg, params, batch["frames"], impl)
        x = embed_tokens(cfg, params, tokens, positions)
    return x, positions, enc_out


def cross_block(cfg: ModelConfig, p, x, enc_out,
                impl: ModelKernels = KERNELS):
    """x + an ``xdec`` layer's cross-attention of its ``norm_x`` over the
    encoder output.  Returns (x, xk, xv): the layer's cross cache."""
    h = apply_norm(cfg.norm, x, p["norm_x"], cfg.norm_eps)
    out, xk, xv = attn.cross_attention(p["xattn"], h, enc_out, cfg, impl)
    return x + out, xk, xv


def cross_decode_block(cfg: ModelConfig, p, x, cache,
                       impl: ModelKernels = KERNELS):
    """x + one decode step's cross-attention over the layer's cross
    cache.  x: (B,1,D)."""
    h = apply_norm(cfg.norm, x, p["norm_x"], cfg.norm_eps)
    return x + attn.cross_decode_attention(p["xattn"], cache["xk"],
                                           cache["xv"], h, cfg, impl)


def mix_prefill(cfg: ModelConfig, kind: str, p, x, tables, cache_len: int,
                impl: ModelKernels = KERNELS, enc_out=None):
    """A layer's first half over the full sequence: x + its mixer
    (attention, SSD or RG-LRU) of its first norm, and for an ``xdec``
    layer its cross-attention over ``enc_out``.  x: (B,S,D).  Returns
    (x, the layer's cache); an attention layer's cache is None when
    ``cache_len`` is (training keeps none)."""
    h = apply_norm(cfg.norm, x, p["norm1"], cfg.norm_eps)
    if kind == "ssd":
        out, cache = ssm_mod.ssd_prefill(p["ssd"], h, cfg, impl)
    elif kind == "rglru":
        out, cache = rglru_mod.rglru_prefill(p["rglru"], h, cfg, impl)
    else:
        out, cache = attn.prefill_attention(p, h, tables, cfg, kind,
                                            cache_len=cache_len, impl=impl)
    x = x + out
    if kind == "xdec":
        x, xk, xv = cross_block(cfg, p, x, enc_out, impl)
        if cache is not None:
            cache["xk"], cache["xv"] = xk, xv
    return x, cache


def mix_decode(cfg: ModelConfig, kind: str, p, x, cache, pos, tables,
               impl: ModelKernels = KERNELS):
    """A layer's first half for one decode step.  x: (B,1,D).  Returns
    (x, the layer's cache): an attention cache is written in place and
    returned, a recurrent one replaced."""
    h = apply_norm(cfg.norm, x, p["norm1"], cfg.norm_eps)
    if kind == "ssd":
        out, cache = ssm_mod.ssd_decode_step(p["ssd"], cache, h, cfg)
    elif kind == "rglru":
        out, cache = rglru_mod.rglru_decode_step(p["rglru"], cache, h, cfg)
    else:
        out, cache = attn.decode_attention(p, cache, h, pos, tables, cfg,
                                           kind, impl=impl)
    x = x + out
    if kind == "xdec":
        x = cross_decode_block(cfg, p, x, cache, impl)
    return x, cache


def block_prefill(cfg: ModelConfig, kind: str, p, x, tables,
                  cache_len: int, impl: ModelKernels = KERNELS,
                  enc_out=None):
    """One layer over the full sequence.  x: (B,S,D).  Returns (x, the
    layer's cache)."""
    x, cache = mix_prefill(cfg, kind, p, x, tables, cache_len, impl,
                           enc_out)
    return (x if kind == "ssd" else ffn_block(cfg, p, x)), cache


def block_decode(cfg: ModelConfig, kind: str, p, x, cache, pos, tables,
                 impl: ModelKernels = KERNELS):
    """One layer, one decode step.  x: (B,1,D).  Returns (x, the layer's
    cache)."""
    x, cache = mix_decode(cfg, kind, p, x, cache, pos, tables, impl)
    return (x if kind == "ssd" else ffn_block(cfg, p, x)), cache


def final_logits(cfg: ModelConfig, params, x):
    """Logits (B, Vpad) of the last position of x (B,S,D)."""
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0]


def prefill(cfg: ModelConfig, params, batch, cache_len: int,
            impl: ModelKernels = KERNELS):
    """batch: ``{"tokens": (B, S) integer ids, ["frames" |
    "image_embeds"]}``.  Returns (cache, last-token logits (B, Vpad))."""
    x, positions, enc_out = assemble_input(cfg, params, batch, impl)
    tables = rope_for(cfg, positions)
    cache = []
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        x, c = block_prefill(cfg, kind, p, x, tables, cache_len, impl,
                             enc_out)
        cache.append(c)
    return cache, final_logits(cfg, params, x)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                impl: ModelKernels = KERNELS):
    """tokens: (B,) integer ids; pos: (B,) int32 absolute positions.
    Returns (logits (B, Vpad), cache) — the list is updated in place."""
    tables = rope_for(cfg, pos[:, None])
    x = embed_tokens(cfg, params, tokens[:, None], pos[:, None])
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        x, cache[i] = block_decode(cfg, kind, p, x, cache[i], pos, tables,
                                   impl)
    return final_logits(cfg, params, x), cache


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------
def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_train(cfg: ModelConfig, kind: str, p, x, tables,
                impl: ModelKernels = KERNELS, enc_out=None):
    """One layer over the full sequence for training: (x, aux), aux the
    layer's MoE load-balancing loss (0 for a dense feed-forward or an
    ``ssd`` layer)."""
    x, _ = mix_prefill(cfg, kind, p, x, tables, None, impl, enc_out)
    if kind == "ssd":
        return x, _zero_aux(x)
    x, aux = ffn_aux(cfg, p, x)
    return x, (_zero_aux(x) if aux is None else aux)


def forward_train(cfg: ModelConfig, params, batch, remat: bool = False,
                  impl: ModelKernels = KERNELS):
    """batch: ``{"tokens", "targets", ["image_embeds" | "frames"]}``.
    Returns (loss + 0.01 · aux (fp32), metrics ``{"loss", "aux_loss",
    "ppl_proxy"}``), as the reference's ``forward_train``.

    aux sums the MoE layers' Switch losses.  A VLM scores only its text
    positions, and a target < 0 is masked out of the mean.  ``remat``
    wraps each superblock (one repetition of ``cfg.pattern``; the tail
    layers run as they are, as in the reference) in
    ``torch.utils.checkpoint`` without re-entry, so the backward pass
    recomputes it from its input: the numbers are the same, the
    activations held are fewer.  On the card the attention, SSD and
    RG-LRU layers launch their kernels forward and backward."""
    from torch.utils.checkpoint import checkpoint
    x, positions, enc_out = assemble_input(cfg, params, batch, impl)
    tables = rope_for(cfg, positions)
    kinds, layers = layer_kinds(cfg), params["layers"]
    pat = len(cfg.pattern)

    def superblock(x, lo):
        aux = _zero_aux(x)
        for i in range(lo, lo + pat):
            x, a = block_train(cfg, kinds[i], layers[i], x, tables, impl,
                               enc_out)
            aux = aux + a
        return x, aux

    aux = _zero_aux(x)
    for lo in range(0, cfg.n_superblocks * pat, pat):
        if remat:
            x, a = checkpoint(superblock, x, lo, use_reentrant=False)
        else:
            x, a = superblock(x, lo)
        aux = aux + a
    for i in range(cfg.n_superblocks * pat, len(kinds)):
        x, a = block_train(cfg, kinds[i], layers[i], x, tables, impl,
                           enc_out)
        aux = aux + a
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps)
    if cfg.vlm is not None:  # predict only over text positions
        x = x[:, -batch["tokens"].shape[1]:]
    logits = unembed(cfg, params, x)
    targets = batch["targets"].to(torch.int64)
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (targets >= 0).float()
    nll = -torch.gather(logp, -1, torch.clamp_min(targets, 0)[..., None]
                        )[..., 0]
    loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss.detach(), "aux_loss": aux.detach(),
                   "ppl_proxy": torch.exp(torch.clamp(loss.detach(), 0.0,
                                                      20.0))}
