"""Decoder blocks — the counterparts of ``repro.models.blocks`` for the
kinds ``attn`` (pre-norm attention + pre-norm MLP) and ``attn_moe``
(pre-norm attention + pre-norm MoE).  ``rec`` (RG-LRU) and ``ssd``
(Mamba-2) are not ported yet and raise.

``build_segments`` is the reference's grouping of layers into scanned
segments; the port runs its layers in a Python loop and uses the segments
only to read the reference's stacked parameters
(``repro_torch.interop.params_from_numpy``).  Layer ``i`` of the loop is
the reference's ``seg.base + step * len(seg.unit) + j``, so the MoE
router's salt is the absolute layer index in both.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers.common import (
    apply_mlp,
    apply_norm,
    init_mlp,
    init_norm,
    not_ported,
    torch_dtype,
)

KINDS = ("attn", "attn_moe")


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


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise not_ported(f"the {kind!r} block (RG-LRU, SSD)")


def init_block(gen, kind: str, cfg: ArchConfig) -> dict:
    _check_kind(kind)
    attn_mod.check_supported(cfg)
    p = {
        "norm1": init_norm(cfg, cfg.d_model, gen.device),
        "mixer": attn_mod.init_attention(gen, cfg),
        "norm2": init_norm(cfg, cfg.d_model, gen.device),
    }
    if kind == "attn_moe":
        p["moe"] = moe_mod.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _ffn(p, kind, x, token_ids, salt, cfg: ArchConfig):
    h2 = apply_norm(p["norm2"], x, cfg)
    if kind == "attn_moe":
        return moe_mod.apply_moe(p["moe"], h2, token_ids, salt, cfg)
    return apply_mlp(p["mlp"], h2, cfg), torch.zeros((), device=x.device)


def block_prefill(p, kind, x, positions, token_ids, salt: int, cfg: ArchConfig, cache_len: int):
    """-> (x, cache, aux)"""
    _check_kind(kind)
    mix, cache = attn_mod.attention_prefill(
        p["mixer"], apply_norm(p["norm1"], x, cfg), positions, cfg, cache_len
    )
    x = x + mix
    y, aux = _ffn(p, kind, x, token_ids, salt, cfg)
    return x + y, cache, aux


def block_decode(p, kind, x, pos: int, cache, token_ids, salt: int, cfg: ArchConfig):
    """x (B,1,D) -> (x, cache), the cache updated in place."""
    _check_kind(kind)
    mix, cache = attn_mod.attention_decode(p["mixer"], apply_norm(p["norm1"], x, cfg), pos, cache, cfg)
    x = x + mix
    y, _ = _ffn(p, kind, x, token_ids, salt, cfg)
    return x + y, cache


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int, device) -> dict:
    """Empty cache for one block: k/v (B,T,G,hd) zeros, pos (B,T) -1."""
    _check_kind(kind)
    attn_mod.check_supported(cfg)
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(batch, cache_len, G, hd, dtype=dt, device=device),
        "v": torch.zeros(batch, cache_len, G, hd, dtype=dt, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def block_cache_len(kind: str, cfg: ArchConfig, max_len: int) -> int:
    if kind in KINDS and cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len
