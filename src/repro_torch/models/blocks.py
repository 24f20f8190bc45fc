"""Decoder blocks — the counterparts of ``repro.models.blocks``:

    attn      — pre-norm attention + pre-norm MLP
    attn_moe  — pre-norm attention + pre-norm MoE
    rec       — pre-norm RG-LRU + pre-norm MLP (RecurrentGemma)
    ssd       — pre-norm Mamba-2 SSD mixer only

The attention is GQA (full causal or sliding-window) or, with
``cfg.attention == "mla"``, Multi-head Latent Attention with its latent
cache.  Every decode updates its layer's cache in place.

``build_segments`` is the reference's grouping of layers into scanned
segments.  Serving runs its layers in a Python loop over per-layer
parameters; training holds the reference's stacked parameters, one leaf
of shape ``(count, ...)`` per segment and sub-block, and runs the same
loop over views of them (``repro_torch.models.model``).  Layer ``i`` of
the loop is the reference's ``seg.base + step * len(seg.unit) + j``
(``layer_index``), so the MoE router's salt is the absolute layer index in
both.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers import rglru as rglru_mod
from repro_torch.models.layers import ssd as ssd_mod
from repro_torch.sharding import rules
from repro_torch.models.layers.common import (
    apply_mlp,
    apply_norm,
    init_mlp,
    init_norm,
    torch_dtype,
)


@dataclass(frozen=True)
class Segment:
    unit: tuple[str, ...]  # block kinds in one scan step
    count: int  # scan length
    base: int  # absolute index of the first layer in this segment


def build_segments(cfg: ArchConfig) -> list[Segment]:
    kinds = cfg.layer_kinds()
    segs: list[Segment] = []
    if len(cfg.pattern) > 1:
        unit_len = len(cfg.pattern)
        n_super = len(kinds) // unit_len
        if n_super > 0:
            segs.append(Segment(tuple(kinds[:unit_len]), n_super, 0))
        rest = kinds[n_super * unit_len :]
        base = n_super * unit_len
        i = 0
        while i < len(rest):
            j = i
            while j < len(rest) and rest[j] == rest[i]:
                j += 1
            segs.append(Segment((rest[i],), j - i, base + i))
            i = j
        return segs
    # single-kind pattern: group consecutive identical kinds (moe start split)
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        segs.append(Segment((kinds[i],), j - i, i))
        i = j
    return segs


def layer_index(seg: Segment, step: int, j: int) -> int:
    """The absolute index of sub-block ``j`` at scan step ``step``."""
    return seg.base + step * len(seg.unit) + j


ATTN_KINDS = ("attn", "attn_moe")
KINDS = (*ATTN_KINDS, "rec", "ssd")


def init_block(gen, kind: str, cfg: ArchConfig) -> dict:
    p = {"norm1": init_norm(cfg, cfg.d_model, gen.device)}
    if kind in ATTN_KINDS:
        if cfg.attention == "mla":
            p["mixer"] = mla_mod.init_mla(gen, cfg)
        else:
            p["mixer"] = attn_mod.init_attention(gen, cfg)
        p["norm2"] = init_norm(cfg, cfg.d_model, gen.device)
        if kind == "attn_moe":
            p["moe"] = moe_mod.init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg)
    elif kind == "rec":
        p["mixer"] = rglru_mod.init_rglru(gen, cfg)
        p["norm2"] = init_norm(cfg, cfg.d_model, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    elif kind == "ssd":
        p["mixer"] = ssd_mod.init_ssd(gen, cfg)
    else:
        raise ValueError(kind)
    return p


def _ffn(p, kind, x, token_ids, salt, cfg: ArchConfig):
    h2 = apply_norm(p["norm2"], x, cfg)
    if kind == "attn_moe":
        return moe_mod.apply_moe(p["moe"], h2, token_ids, salt, cfg)
    return apply_mlp(p["mlp"], h2, cfg), torch.zeros((), device=x.device)


def block_train(p, kind, x, positions, token_ids, salt: int, cfg: ArchConfig):
    """The training forward of one block, no cache: -> (x, aux loss)."""
    h = apply_norm(p["norm1"], x, cfg)
    if kind in ATTN_KINDS:
        train = mla_mod.mla_train if cfg.attention == "mla" else attn_mod.attention_train
        mix = train(p["mixer"], h, positions, cfg)
    elif kind == "rec":
        mix, _ = rglru_mod.rglru_scan(p["mixer"], h, cfg)
    else:
        mix, _ = ssd_mod.ssd_scan(p["mixer"], h, cfg)
    x = x + mix
    if kind == "ssd":
        return x, torch.zeros((), device=x.device)
    y, aux = _ffn(p, kind, x, token_ids, salt, cfg)
    return x + y, aux


def block_prefill(p, kind, x, positions, token_ids, salt: int, cfg: ArchConfig, cache_len: int):
    """-> (x, cache, aux)"""
    h = apply_norm(p["norm1"], x, cfg)
    if kind in ATTN_KINDS:
        prefill = mla_mod.mla_prefill if cfg.attention == "mla" else attn_mod.attention_prefill
        mix, cache = prefill(p["mixer"], h, positions, cfg, cache_len)
    elif kind == "rec":
        mix, cache = rglru_mod.rglru_scan(p["mixer"], h, cfg)
        cache = rules.cache_local(cache)
    else:
        mix, cache = ssd_mod.ssd_scan(p["mixer"], h, cfg)
        cache = rules.cache_local(cache)
    x = x + mix
    if kind == "ssd":
        return x, cache, torch.zeros((), device=x.device)
    y, aux = _ffn(p, kind, x, token_ids, salt, cfg)
    return x + y, cache, aux


def block_decode(p, kind, x, pos: int, cache, token_ids, salt: int, cfg: ArchConfig):
    """x (B,1,D) -> (x, cache), the cache updated in place."""
    h = apply_norm(p["norm1"], x, cfg)
    if kind in ATTN_KINDS:
        decode = mla_mod.mla_decode if cfg.attention == "mla" else attn_mod.attention_decode
        mix, cache = decode(p["mixer"], h, pos, cache, cfg)
    elif kind == "rec":
        mix, cache = rglru_mod.rglru_decode(p["mixer"], h, cache, cfg)
    else:
        mix, cache = ssd_mod.ssd_decode(p["mixer"], h, cache, cfg)
    x = x + mix
    if kind == "ssd":
        return x, cache
    y, _ = _ffn(p, kind, x, token_ids, salt, cfg)
    return x + y, cache


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int, device) -> dict:
    """Empty cache for one block: k/v (B,T,G,hd) zeros, pos (B,T) -1; MLA:
    ckv (B,T,r) and kr (B,T,dr) zeros, pos (B,T) -1; rec: h (B,W) f32 and
    conv (B,cw-1,W) zeros; ssd: state (B,H,hd,N) f32 and conv
    (B,cw-1,conv_dim) zeros.  Under a mesh, the rank's block of each over
    the model axis (``rules.cache_local_shape``; ``batch`` is the rank's
    own)."""
    dt = torch_dtype(cfg.dtype)
    if kind == "rec":
        W, cw = cfg.rglru.lru_width or cfg.d_model, cfg.rglru.conv_width
        spec = {"h": ((batch, W), torch.float32, 0), "conv": ((batch, cw - 1, W), dt, 0)}
    elif kind == "ssd":
        d_inner, H, G, N, hd = ssd_mod.dims(cfg)
        spec = {"state": ((batch, H, hd, N), torch.float32, 0),
                "conv": ((batch, cfg.ssm.conv_width - 1, d_inner + 2 * G * N), dt, 0)}
    elif cfg.attention == "mla":
        m = cfg.mla
        spec = {"ckv": ((batch, cache_len, m.kv_lora_rank), dt, 0),
                "kr": ((batch, cache_len, m.qk_rope_head_dim), dt, 0),
                "pos": ((batch, cache_len), torch.int32, -1)}
    else:
        G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        spec = {"k": ((batch, cache_len, G, hd), dt, 0), "v": ((batch, cache_len, G, hd), dt, 0),
                "pos": ((batch, cache_len), torch.int32, -1)}
    if kind in ATTN_KINDS and rules.axis_size("model") > 1:
        attn_mod._time_block(cache_len)  # the model axis must divide the slots
    return {k: torch.full(rules.cache_local_shape(k, shape), fill, dtype=dtype, device=device)
            for k, (shape, dtype, fill) in spec.items()}


def block_cache_len(kind: str, cfg: ArchConfig, max_len: int) -> int:
    if kind in ATTN_KINDS and cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len
