"""Multi-head Latent Attention (DeepSeek-V2/V3) for serving — the
counterpart of ``repro.models.layers.mla``.

The cache stores only the compressed latent ``ckv`` (``kv_lora_rank`` per
token) and the shared rope key ``kr`` (``qk_rope_head_dim`` per token),
with ``pos`` (-1 for empty slots).  Prefill runs the expanded path (the
latent up-projected to per-head keys and values); decode runs the absorbed
path (``W_uk`` folded into the query, attention against the latent,
``W_uv`` folded into the output), so a step's work scales with the latent
rank, not ``H * hd``.  The two are different float orders of one
function.

The reference computes MLA with jnp products and no Pallas kernel, so
plain torch products are its counterpart here.  Weights keep the
reference's per-head layouts (``(r, H, k)``, ``(H, v, D)``).

Under a mesh whose model axis divides the heads, each rank computes its
heads (the reference's head-sharded q and k): its blocks of the per-head
up-projections, the down-projections and the shared rope key whole on
every rank (``rules.weight(..., use="part")``: their gradients summed over
``model``), and ``wo_attn`` — cut by the rules on its ``v`` dim — re-laid
to the rank's heads, the partial outputs summed over ``model``.  Where
the heads do not divide, every rank computes the whole layer.  Decode
holds the rank's block of the cache's slots and combines the softmax over
the model axis, as ``attention.attention_decode`` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.attention import NEG_INF, _time_block, causal_attention
from repro_torch.models.layers.common import apply_rope, dense_init, rope_cos_sin, torch_dtype
from repro_torch.sharding import rules


def init_mla(gen, cfg: ArchConfig) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    return {
        "w_dq": dense_init(gen, (D, m.q_lora_rank), dt),
        "q_norm_scale": torch.ones(m.q_lora_rank, dtype=torch.float32, device=dev),
        "w_uq": dense_init(gen, (m.q_lora_rank, H, m.qk_nope_head_dim), dt),
        "w_qr": dense_init(gen, (m.q_lora_rank, H, m.qk_rope_head_dim), dt),
        "w_dkv": dense_init(gen, (D, m.kv_lora_rank), dt),
        "kv_norm_scale": torch.ones(m.kv_lora_rank, dtype=torch.float32, device=dev),
        "w_kr": dense_init(gen, (D, m.qk_rope_head_dim), dt),
        "w_uk": dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim), dt),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim), dt),
        "wo_attn": dense_init(gen, (H, m.v_head_dim, D), dt,
                              scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, cast back to the input's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _shapes(cfg: ArchConfig) -> dict:
    """Each MLA weight's full shape."""
    m, D, H = cfg.mla, cfg.d_model, cfg.num_heads
    return {"w_dq": (D, m.q_lora_rank), "w_uq": (m.q_lora_rank, H, m.qk_nope_head_dim),
            "w_qr": (m.q_lora_rank, H, m.qk_rope_head_dim), "w_dkv": (D, m.kv_lora_rank),
            "w_kr": (D, m.qk_rope_head_dim), "w_uk": (m.kv_lora_rank, H, m.qk_nope_head_dim),
            "w_uv": (m.kv_lora_rank, H, m.v_head_dim), "wo_attn": (H, m.v_head_dim, D)}


def _heads_cut(cfg: ArchConfig) -> str | None:
    """``"model"`` where the rules cut the heads over the model axis."""
    return rules.model_cut("w_uq", _shapes(cfg)["w_uq"], 1)


def _weights(p, cfg: ArchConfig, cut) -> dict:
    """This rank's MLA weights: with ``cut``, its heads of the per-head
    projections (and of ``wo_attn``) and the rest whole, used in its part;
    else every weight whole."""
    shapes = _shapes(cfg)
    use = "part" if cut else "whole"
    w = {n: rules.weight(p, n, shapes[n], (None, cut, None) if n in ("w_uq", "w_qr", "w_uk", "w_uv")
                         else (cut, None, None) if n == "wo_attn" else (), use=use)
         for n in shapes}
    for n in ("q_norm_scale", "kv_norm_scale"):
        w[n] = rules.copy_to(p[n], cut) if cut else p[n]
    return w


def _latents(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """x (B,S,D) -> q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,r),
    k_rope (B,S,dr), rope applied (the rope key is one head, shared);
    ``p`` the weights as ``_weights`` gives them (the rank's heads)."""
    m = cfg.mla
    cq = _rms(x @ p["w_dq"], p["q_norm_scale"])
    q_nope = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    q_rope = torch.einsum("bsr,rhk->bshk", cq, p["w_qr"])
    c_kv = _rms(x @ p["w_dkv"], p["kv_norm_scale"])
    k_rope = x @ p["w_kr"]
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _train(w, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, cut, latents=None):
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = latents or _latents(w, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, w["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, w["w_uv"])
    B, S, H = x.shape[0], x.shape[1], q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)  # (B,S,H,dn+dr)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(q_rope.shape)], dim=-1)
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    vpad = torch.nn.functional.pad(v, (0, dq - m.v_head_dim))
    out = causal_attention(q.reshape(B, S, H, 1, dq), k, vpad, positions, positions)
    out = out.reshape(B, S, H, dq)[..., : m.v_head_dim]
    out = torch.einsum("bshk,hkd->bsd", out, w["wo_attn"])
    return rules.reduce_from(out, cut) if cut else out


def mla_train(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The expanded path, the training forward and prefill's: per-head
    keys and values from the latent, the rope key broadcast to every head,
    ``v`` padded to ``dn + dr`` so that the shared causal attention
    (scaled by ``1/sqrt(dn + dr)``) runs, then sliced back.  -> (B,S,D)."""
    cut = _heads_cut(cfg)
    if cut:
        x = rules.copy_to(x, cut)
    return _train(_weights(p, cfg, cut), x, positions, cfg, cut)


def mla_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, cache_len: int):
    """Prefill: -> (out (B,S,D), cache {ckv, kr, pos} padded to cache_len;
    under a mesh the rank's block of the slots)."""
    cut = _heads_cut(cfg)
    xin = rules.copy_to(x, cut) if cut else x
    w = _weights(p, cfg, cut)
    latents = _latents(w, xin, cfg, positions)
    out = _train(w, xin, positions, cfg, cut, latents)
    _, _, c_kv, k_rope = latents
    pad = cache_len - x.shape[1]
    cache = {
        "ckv": torch.nn.functional.pad(c_kv, (0, 0, 0, pad)),
        "kr": torch.nn.functional.pad(k_rope, (0, 0, 0, pad)),
        "pos": torch.nn.functional.pad(positions.to(torch.int32), (0, pad), value=-1),
    }
    if rules.axis_size("model") > 1:
        t = _time_block(cache_len)
        cache = {k: v[:, t].contiguous() for k, v in cache.items()}
    return out, cache


def mla_decode(p, x: torch.Tensor, pos: int, cache: dict, cfg: ArchConfig):
    """Absorbed one-token decode against the latent cache: x (B,1,D) ->
    (out, cache).  Writes the token's latent, rope key and position into
    ``cache`` in place (the reference returns a new cache)."""
    m = cfg.mla
    B = x.shape[0]
    tp = rules.axis_size("model")
    Tl = cache["ckv"].shape[1]
    w = _weights(p, cfg, None)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _latents(w, x, cfg, positions)
    if pos // Tl == rules.axis_index("model"):
        cache["ckv"][:, pos % Tl] = c_new[:, 0]
        cache["kr"][:, pos % Tl] = kr_new[:, 0]
        cache["pos"][:, pos % Tl] = pos
    ckv, kr, pc = cache["ckv"], cache["kr"], cache["pos"]
    # absorb W_uk: q_abs (B,1,H,r) = q_nope @ W_uk^T
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w["w_uk"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())) * scale
    valid = (pc >= 0) & (pc <= pos)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    # attend against the latent, then absorb W_uv
    if tp == 1:
        o_lat = torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1).to(ckv.dtype), ckv)
    else:
        mx = rules.all_reduce_max(s.amax(-1, keepdim=True), "model")
        e = torch.exp(s - mx)
        den = rules.all_reduce(e.sum(-1), "model")  # (B,H,1)
        o_lat = torch.einsum("bhst,btr->bshr", e.to(ckv.dtype), ckv).float()
        o_lat = (rules.all_reduce(o_lat, "model") / den.transpose(1, 2)[..., None]).to(ckv.dtype)
    out = torch.einsum("bshr,rhk->bshk", o_lat, w["w_uv"])
    return torch.einsum("bshk,hkd->bsd", out, w["wo_attn"]), cache
