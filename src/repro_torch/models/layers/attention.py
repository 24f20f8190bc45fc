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

Under a mesh (``repro_torch.sharding.rules``) the fused projections are
column-parallel and ``wo_attn`` row-parallel where
``attention_sharding_mode`` lets each rank take whole heads; the mode is
picked from G, R and S at the reference's call sites (a windowed layer
never takes ``seq``).  Prefill keeps the rank's block of the cache's
slots (``rules.cache_pspecs`` cuts the time axis over ``model``), with
every KV head, and decode combines the softmax over the slots across the
model axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding import rules
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


def attention_sharding_mode(G: int, R: int, S: int, windowed: bool) -> str:
    """How a rank computes attention over the model axis of the active
    mesh — the reference's choice, as per-rank work:

    head  — KV heads divide tp: the rank's KV-head groups, with their
            queries, from its columns of ``wq``/``wk``/``wv``; no
            attention traffic;
    rhead — query-rep heads divide tp: the rank's query heads, k/v
            gathered whole (its columns of ``wk``/``wv`` projected, then
            all-gathered; or the weights whole where they are not cut);
    seq   — neither divides: the rank's block of the query positions
            against every key, the weights gathered over ``model`` —
            context parallelism (never with a window);
    local — no split (tiny meshes / no mesh): the weights gathered over
            ``model`` and the whole attention on every rank.
    """
    tp = rules.axis_size("model")
    if tp <= 1:
        return "local"
    if G % tp == 0:
        return "head"
    if R % tp == 0:
        return "rhead"
    if S % tp == 0 and not windowed:
        return "seq"
    return "local"


def _linear(x, p, name: str, bias: str, shape, want, use: str, cut) -> torch.Tensor:
    """``x @ w (+ b)`` with ``w`` this rank's block of ``p[name]`` in the
    layout ``want`` and the bias cut to match (``cut`` the axis that cuts
    the product's columns)."""
    y = x @ rules.weight(p, name, shape, want, use=use)
    if bias not in p:
        return y
    if cut:
        return y + rules.part(p[bias], 0, cut)
    return y + (rules.copy_to(p[bias], "model") if use == "part" else p[bias])


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, mode: str = "local"):
    """x (B,S,D) -> q (B,Sq,G',R',hd), k/v (B,S,G',hd) with rope or M-RoPE
    applied (positions (B,S), or (3,B,S) for M-RoPE), the queries' rows
    of the sequence (a slice), and ``(k, v, g0)``: the keys and values
    this rank computed, KV heads ``[g0, g0 + their count)``.

    Without a mesh (or in ``local`` mode) ``G' = G``, ``R' = R`` and every
    row is a query.  Under a mesh (``attention_sharding_mode``) the rank's
    query heads ``[h0, h0 + Hq)`` are regrouped against the KV heads
    they read: whole groups (``G' = Hq / R``), one group (``G' = 1``,
    ``R' = Hq``), or one head per group (``R' = 1``)."""
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    R, D = H // KVH, cfg.d_model
    B, S = x.shape[:2]
    tp, idx = rules.axis_size("model"), rules.axis_index("model")
    use = "whole" if mode == "local" else "part"
    if use == "part":
        x = rules.copy_to(x, "model")
    rows = slice(0, S)
    qshape, kvshape = (D, H * hd), (D, KVH * hd)
    if mode in ("head", "rhead"):
        Hq, h0 = H // tp, idx * (H // tp)
        q = _linear(x, p, "wq", "bq", qshape, (None, "model"), use, "model")
        if mode == "head":
            Gk, g0 = KVH // tp, idx * (KVH // tp)
            k = _linear(x, p, "wk", "bk", kvshape, (None, "model"), use, "model")
            v = _linear(x, p, "wv", "bv", kvshape, (None, "model"), use, "model")
        else:
            Gk, g0 = KVH, 0
            kcut = rules.model_cut("wk", kvshape, 1)
            k = _linear(x, p, "wk", "bk", kvshape, (None, kcut), use, kcut)
            v = _linear(x, p, "wv", "bv", kvshape, (None, kcut), use, kcut)
            if kcut:
                k, v = rules.gather(k, kcut, -1), rules.gather(v, kcut, -1)
    else:
        Hq, h0, Gk, g0 = H, 0, KVH, 0
        if mode == "seq":
            rows = slice(idx * (S // tp), (idx + 1) * (S // tp))
        q = _linear(x[:, rows], p, "wq", "bq", qshape, (), use, None)
        k = _linear(x, p, "wk", "bk", kvshape, (), use, None)
        v = _linear(x, p, "wv", "bv", kvshape, (), use, None)
    Sq = q.shape[1]
    q = q.reshape(B, Sq, Hq, hd)
    k = k.reshape(B, S, Gk, hd)
    v = v.reshape(B, S, Gk, hd)
    if cfg.qk_norm:
        q = rms_head_norm(rules.copy_to(p["q_norm"], "model") if use == "part" else p["q_norm"], q)
        k = rms_head_norm(rules.copy_to(p["k_norm"], "model") if use == "part" else p["k_norm"], k)
    if cfg.pos_emb in ("rope", "mrope"):
        cos, sin = _cos_sin(cfg, positions, hd)
        q = apply_rope(q, cos[..., rows, :], sin[..., rows, :], cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    gl = h0 // R - g0  # the first KV head the queries read, within k
    if Hq % R == 0 and h0 % R == 0:
        Gq, Rq = Hq // R, R
        ks, vs = (k, v) if Gq == Gk else (k[:, :, gl:gl + Gq], v[:, :, gl:gl + Gq])
    elif R % Hq == 0:
        Gq, Rq = 1, Hq
        ks, vs = k[:, :, gl:gl + 1], v[:, :, gl:gl + 1]
    else:
        Gq, Rq = Hq, 1
        groups = torch.arange(h0, h0 + Hq, device=k.device) // R - g0
        ks, vs = k[:, :, groups], v[:, :, groups]
    return q.reshape(B, Sq, Gq, Rq, hd), ks, vs, rows, (k, v, g0)


def _output(p, out: torch.Tensor, cfg: ArchConfig, mode: str) -> torch.Tensor:
    """The attention output (B,Sq,Hq*hd) of this rank's queries -> the
    layer's output (B,S,D), replicated over ``model``: row-parallel
    ``wo_attn`` summed over ``model`` (``head``/``rhead``), the rows
    gathered over ``model`` (``seq``), or whole (``local``)."""
    shape = (cfg.num_heads * cfg.resolved_head_dim, cfg.d_model)
    if mode in ("head", "rhead"):
        return rules.reduce_from(out @ rules.weight(p, "wo_attn", shape, ("model", None)), "model")
    if mode == "seq":
        return rules.gather(out @ rules.weight(p, "wo_attn", shape, (), use="part"), "model", 1,
                            grad="block")
    return out @ rules.weight(p, "wo_attn", shape)


def _mode(cfg: ArchConfig, S: int) -> str:
    KVH = cfg.num_kv_heads
    return attention_sharding_mode(KVH, cfg.num_heads // KVH, S, cfg.window is not None)


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
    mode = _mode(cfg, x.shape[1])
    q, k, v, rows, _ = _project_qkv(p, x, cfg, positions, mode)
    qpos = positions[-1] if cfg.pos_emb == "mrope" else positions
    out = causal_attention(q, k, v, qpos[:, rows], qpos, window=cfg.window)
    return _output(p, out.reshape(*out.shape[:2], -1), cfg, mode)


def _time_block(T: int) -> slice:
    """The rank's block of a cache's time axis under the active mesh: the
    model axis cuts it (``rules.cache_pspecs``), and must divide it."""
    tp = rules.axis_size("model")
    if T % tp:
        raise ValueError(f"a cache of {T} slots does not split over {tp} model ranks")
    n = T // tp
    return slice(rules.axis_index("model") * n, (rules.axis_index("model") + 1) * n)


def attention_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, cache_len: int):
    """Prefill: -> (out (B,S,D), cache {k, v, pos} of cache_len slots).

    A windowed layer whose cache is the window (``cache_len == window``)
    and whose prompt fills it keeps the last ``cache_len`` rows, rolled by
    ``S % cache_len`` so that slot ``pos % window`` holds ``pos``;
    otherwise the rows are padded with position -1.  Under a mesh the
    rank keeps its block of the slots (``_time_block``), every KV head."""
    B, S = x.shape[:2]
    mode = _mode(cfg, S)
    q, k, v, rows, (k_all, v_all, _) = _project_qkv(p, x, cfg, positions, mode)
    qpos = positions[-1] if cfg.pos_emb == "mrope" else positions
    out = causal_attention(q, k, v, qpos[:, rows], qpos, window=cfg.window)
    out = _output(p, out.reshape(*out.shape[:2], -1), cfg, mode)
    if mode == "head":
        k_all, v_all = rules.all_gather(k_all, "model", 2), rules.all_gather(v_all, "model", 2)
    k, v = k_all, v_all
    qpos = qpos.to(torch.int32)
    if cfg.window is not None and cache_len == cfg.window and S >= cache_len:
        roll = S % cache_len
        k_c, v_c, p_c = (torch.roll(t[:, -cache_len:], roll, dims=1) for t in (k, v, qpos))
    else:
        pad = cache_len - S
        k_c = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_c = F.pad(v, (0, 0, 0, 0, 0, pad))
        p_c = F.pad(qpos, (0, pad), value=-1)
    if rules.axis_size("model") > 1:
        t = _time_block(cache_len)
        k_c, v_c, p_c = k_c[:, t].contiguous(), v_c[:, t].contiguous(), p_c[:, t].contiguous()
    return out, {"k": k_c, "v": v_c, "pos": p_c}


def attention_decode(p, x: torch.Tensor, pos: int, cache: dict, cfg: ArchConfig):
    """One-token decode. x (B,1,D); pos the position of this token; cache
    dict of k/v (B,T,G,hd) and pos (B,T). -> (out, cache).

    Writes the new token's k/v/pos into slot ``pos % T`` of ``cache`` in
    place (the reference returns a new cache): a step copies no cache, and
    a windowed layer's ring overwrites the position that left the window.

    Under a mesh whose model axis has more than one rank the cache is the
    rank's block of the slots (``_time_block``): each rank projects every
    head (the weights gathered over ``model``), the rank holding slot
    ``pos % T`` writes it, and the softmax over the slots is combined
    across the model axis (flash-decoding: the maximum, the sum of the
    weights and the weighted values all-reduced)."""
    B = x.shape[0]
    tp = rules.axis_size("model")
    Tl = cache["k"].shape[1]
    T = Tl * tp
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.pos_emb == "mrope":
        positions = positions.expand(3, B, 1)
    q, k_new, v_new, _, _ = _project_qkv(p, x, cfg, positions)
    slot = pos % T
    if slot // Tl == rules.axis_index("model"):
        cache["k"][:, slot % Tl] = k_new[:, 0]
        cache["v"][:, slot % Tl] = v_new[:, 0]
        cache["pos"][:, slot % Tl] = pos
    k_c, v_c, p_c = cache["k"], cache["v"], cache["pos"]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k_c.float()) * scale
    valid = (p_c >= 0) & (p_c <= pos)
    if cfg.window is not None:
        valid = valid & (p_c > pos - cfg.window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    if tp == 1:
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v_c.dtype), v_c)
    else:
        m = rules.all_reduce_max(s.amax(-1, keepdim=True), "model")
        w = torch.exp(s - m)
        den = rules.all_reduce(w.sum(-1), "model")  # (B,G,R,1)
        out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v_c.dtype), v_c).float()
        out = rules.all_reduce(out, "model") / den.permute(0, 3, 1, 2)[..., None]
        out = out.to(v_c.dtype)
    out = out.reshape(B, 1, -1) @ rules.weight(
        p, "wo_attn", (cfg.num_heads * cfg.resolved_head_dim, cfg.d_model))
    return out, cache
