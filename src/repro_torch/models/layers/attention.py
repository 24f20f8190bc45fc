"""GQA attention for serving: causal prefill, full or sliding-window, and
cached one-token decode — the counterparts of
``repro.models.layers.attention``.

The reference computes attention with jnp ops and no Pallas kernel, so
plain torch products and a softmax are its honest counterpart here.  Its
prefill scans KV chunks of 512 with an online softmax; up to 512 cached
positions that is one chunk.  ``causal_attention`` takes the queries in
chunks of 512, each with one direct softmax over its keys (unnormalised
``exp(s - max)`` weights in the values' dtype, divided by their f32 sum
afterwards), so up to 512 positions it computes what the reference's
one chunk does.  Scores are f32, as the reference's
``preferred_element_type=float32`` makes them.  With a sliding window the
reference scans query chunks of 512 against only their band of KV chunks;
here each query chunk takes its band of keys only, so no score outside
``window + chunk`` keys is ever built.  Weights are
stored fused, ``(D, H*hd)``, and the cache is the reference's dict
``{k, v, pos}``: k/v ``(B, T, G, hd)``, pos ``(B, T)`` with -1 for empty
slots; a windowed layer's cache of ``window`` slots is a ring, slot
``pos % window`` holding position ``pos``.

Positions are rope (``rope_fraction`` of the head dim), M-RoPE (three
position streams ``(3, B, S)``; the mask and the cache read the last one,
``positions[-1]``, as the reference's do) or none (sinusoidal, added to
the embeddings by the model).  MLA is ``repro_torch.models.layers.mla``.
The training forward (``attention_train``) is prefill's attention
without the cache; under autograd each query chunk's attention is
checkpointed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.common import (
    apply_rope,
    dense_init,
    mrope_cos_sin,
    rms_head_norm,
    rope_cos_sin,
    torch_dtype,
)

NEG_INF = -1e30
#: the reference's query (and KV) chunk of the banded windowed prefill
Q_CHUNK = 512


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


def _cos_sin(cfg: ArchConfig, positions: torch.Tensor, hd: int):
    if cfg.pos_emb == "mrope":
        return mrope_cos_sin(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_cos_sin(positions, int(hd * cfg.rope_fraction) // 2 * 2, cfg.rope_theta)


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,G,R,hd), k/v (B,S,G,hd) with rope or M-RoPE
    applied (positions (B,S), or (3,B,S) for M-RoPE)."""
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
    if cfg.pos_emb in ("rope", "mrope"):
        cos, sin = _cos_sin(cfg, positions, hd)
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    return q.reshape(B, S, KVH, H // KVH, hd), k, v


def _attend(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B,S,G,R,hd); k/v (B,T,G,hd); mask (B,1,S,1,T) -> (B,S,G,R,hd).

    The reference's online softmax over one KV chunk: weights
    ``exp(s - max)`` cast to the values' dtype, the sum taken in f32 after
    the product."""
    s = torch.einsum("bsgrd,bkgd->bgsrk", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    w = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bgsrk,bkgd->bgsrd", w.to(v.dtype), v).float()
    out = out / w.sum(-1).clamp(min=1e-30)[..., None]  # (B,G,S,R,hd)
    return out.movedim(1, 2).to(q.dtype)


def causal_attention(q, k, v, q_positions, kv_positions, window: int | None = None,
                     q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """q (B,S,G,R,hd); k/v (B,T,G,hd); positions (B,S)/(B,T) -> (B,S,G,R,hd).

    Key ``j`` is seen by query ``i`` when ``kv_pos[j] <= q_pos[i]`` and,
    with a ``window``, ``kv_pos[j] > q_pos[i] - window``.  The queries go
    in chunks of ``q_chunk``: full causal, each chunk against every key
    (the mask decides, whatever the order of the positions); windowed,
    the chunk ``[lo, hi)`` against only its band of keys ``[lo - window +
    1, hi)`` (the band is taken by index, as the reference's static band of
    KV chunks is, so keys and queries are one sequence at positions in
    order).  Under autograd each chunk is checkpointed: its backward keeps
    q, k, v and its output and recomputes its scores, so no score wider
    than one chunk is ever kept (the reference's online softmax over KV
    chunks of 512 keeps a chunk's scores per scan step)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    S, T = q.shape[1], k.shape[1]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for lo in range(0, S, q_chunk):
        hi = min(lo + q_chunk, S)
        k_lo, k_hi = (0, T) if window is None else (max(0, lo - window + 1), hi)
        qp, kp = q_positions[:, lo:hi, None], kv_positions[:, None, k_lo:k_hi]
        mask = kp <= qp
        if window is not None:
            mask = mask & (kp > qp - window)
        args = (q[:, lo:hi], k[:, k_lo:k_hi], v[:, k_lo:k_hi], mask[:, None, :, None, :], scale)
        outs.append(checkpoint(_attend, *args, use_reentrant=False) if grad else _attend(*args))
    return torch.cat(outs, dim=1)


def attention_train(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The training forward: x (B,S,D) -> (B,S,D), no cache."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    qpos = positions[-1] if cfg.pos_emb == "mrope" else positions
    out = causal_attention(q, k, v, qpos, qpos, window=cfg.window)
    return out.reshape(*x.shape[:2], -1) @ p["wo_attn"]


def attention_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, cache_len: int):
    """Prefill: -> (out (B,S,D), cache {k, v, pos} of cache_len slots).

    A windowed layer whose cache is the window (``cache_len == window``)
    and whose prompt fills it keeps the last ``cache_len`` rows, rolled by
    ``S % cache_len`` so that slot ``pos % window`` holds ``pos``;
    otherwise the rows are padded with position -1."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    qpos = positions[-1] if cfg.pos_emb == "mrope" else positions
    out = causal_attention(q, k, v, qpos, qpos, window=cfg.window)
    B, S = x.shape[:2]
    out = out.reshape(B, S, -1) @ p["wo_attn"]
    qpos = qpos.to(torch.int32)
    if cfg.window is not None and cache_len == cfg.window and S >= cache_len:
        roll = S % cache_len
        k_c, v_c, p_c = (torch.roll(t[:, -cache_len:], roll, dims=1) for t in (k, v, qpos))
    else:
        pad = cache_len - S
        k_c = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_c = F.pad(v, (0, 0, 0, 0, 0, pad))
        p_c = F.pad(qpos, (0, pad), value=-1)
    return out, {"k": k_c, "v": v_c, "pos": p_c}


def attention_decode(p, x: torch.Tensor, pos: int, cache: dict, cfg: ArchConfig):
    """One-token decode. x (B,1,D); pos the position of this token; cache
    dict of k/v (B,T,G,hd) and pos (B,T). -> (out, cache).

    Writes the new token's k/v/pos into slot ``pos % T`` of ``cache`` in
    place (the reference returns a new cache): a step copies no cache, and
    a windowed layer's ring overwrites the position that left the window."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.pos_emb == "mrope":
        positions = positions.expand(3, B, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    slot = pos % T
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][:, slot] = pos
    k_c, v_c, p_c = cache["k"], cache["v"], cache["pos"]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k_c.float()) * scale
    valid = (p_c >= 0) & (p_c <= pos)
    if cfg.window is not None:
        valid = valid & (p_c > pos - cfg.window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v_c.dtype), v_c)
    out = out.reshape(B, 1, -1) @ p["wo_attn"]
    return out, cache
