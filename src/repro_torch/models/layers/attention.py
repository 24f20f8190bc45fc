"""GQA attention for serving: full-causal prefill and cached one-token
decode — the counterparts of ``repro.models.layers.attention``.

The reference computes attention with jnp ops and no Pallas kernel, so
plain torch products and a softmax are its honest counterpart here.  Its
prefill scans KV chunks of 512 with an online softmax; up to 512 cached
positions that is one chunk, which is what ``attention_prefill`` computes
directly (unnormalised ``exp(s - max)`` weights in the values' dtype,
divided by their f32 sum afterwards).  Scores are f32, as the reference's
``preferred_element_type=float32`` makes them.  Weights are stored fused,
``(D, H*hd)``, and the cache is the reference's dict ``{k, v, pos}``:
k/v ``(B, T, G, hd)``, pos ``(B, T)`` with -1 for empty slots.

Sliding windows are not ported yet and raise; MLA is
``repro_torch.models.layers.mla``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.common import (
    apply_rope,
    dense_init,
    not_ported,
    rms_head_norm,
    rope_cos_sin,
    torch_dtype,
)

NEG_INF = -1e30


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the attention flavours the port does not have yet (GQA
    runs here, MLA in ``repro_torch.models.layers.mla``)."""
    if cfg.attention not in ("gqa", "mla"):
        raise not_ported(f"attention={cfg.attention!r}")
    if cfg.window is not None:
        raise not_ported("sliding-window attention and its ring-buffer cache")
    if cfg.pos_emb != "rope":
        raise not_ported(f"pos_emb={cfg.pos_emb!r} (M-RoPE, sinusoidal)")


def init_attention(gen, cfg: ArchConfig) -> dict:
    D, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (D, H * hd), dt),
        "wk": dense_init(gen, (D, KVH * hd), dt),
        "wv": dense_init(gen, (D, KVH * hd), dt),
        "wo_attn": dense_init(gen, (H * hd, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KVH * hd), ("bv", KVH * hd)):
            p[name] = torch.zeros(width, dtype=dt, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=gen.device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,G,R,hd), k/v (B,S,G,hd) with rope applied."""
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S = x.shape[:2]
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    cos, sin = rope_cos_sin(positions, int(hd * cfg.rope_fraction) // 2 * 2, cfg.rope_theta)
    q = apply_rope(q, cos, sin, cfg.rope_fraction)
    k = apply_rope(k, cos, sin, cfg.rope_fraction)
    return q.reshape(B, S, KVH, H // KVH, hd), k, v


def causal_attention(q, k, v, q_positions, kv_positions) -> torch.Tensor:
    """q (B,S,G,R,hd); k/v (B,T,G,hd); positions (B,S)/(B,T) -> (B,S,G,R,hd).

    The reference's online softmax over one KV chunk: weights
    ``exp(s - max)`` cast to the values' dtype, the sum taken in f32 after
    the product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bsgrd,bkgd->bgsrk", q.float(), k.float()) * scale
    mask = (kv_positions[:, None, :] <= q_positions[:, :, None])[:, None, :, None, :]
    s = torch.where(mask, s, NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bgsrk,bkgd->bgsrd", w.to(v.dtype), v).float()
    out = out / w.sum(-1).clamp(min=1e-30)[..., None]  # (B,G,S,R,hd)
    return out.movedim(1, 2).to(q.dtype)


def attention_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, cache_len: int):
    """Prefill: -> (out (B,S,D), cache {k, v, pos} padded to cache_len)."""
    check_supported(cfg)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = causal_attention(q, k, v, positions, positions)
    B, S = x.shape[:2]
    out = out.reshape(B, S, -1) @ p["wo_attn"]
    pad = cache_len - S
    k_c = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v_c = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    p_c = torch.nn.functional.pad(positions.to(torch.int32), (0, pad), value=-1)
    return out, {"k": k_c, "v": v_c, "pos": p_c}


def attention_decode(p, x: torch.Tensor, pos: int, cache: dict, cfg: ArchConfig):
    """One-token decode. x (B,1,D); pos the position of this token; cache
    dict of k/v (B,T,G,hd) and pos (B,T). -> (out, cache).

    Writes the new token's k/v/pos into ``cache`` in place (the reference
    returns a new cache): a step copies no cache."""
    check_supported(cfg)
    B = x.shape[0]
    T = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    slot = pos % T
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][:, slot] = pos
    k_c, v_c, p_c = cache["k"], cache["v"], cache["pos"]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k_c.float()) * scale
    valid = (p_c >= 0) & (p_c <= pos)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v_c.dtype), v_c)
    out = out.reshape(B, 1, -1) @ p["wo_attn"]
    return out, cache
