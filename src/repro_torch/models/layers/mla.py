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
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.attention import NEG_INF, causal_attention
from repro_torch.models.layers.common import apply_rope, dense_init, rope_cos_sin, torch_dtype


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


def _latents(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """x (B,S,D) -> q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,r),
    k_rope (B,S,dr), rope applied (the rope key is one head, shared)."""
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


def mla_train(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
              latents=None) -> torch.Tensor:
    """The expanded path, the training forward and prefill's: per-head
    keys and values from the latent, the rope key broadcast to every head,
    ``v`` padded to ``dn + dr`` so that the shared causal attention
    (scaled by ``1/sqrt(dn + dr)``) runs, then sliced back; ``latents``
    are ``_latents``' outputs where the caller has them.  -> (B,S,D)."""
    m = cfg.mla
    H = cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = latents or _latents(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
    B, S = x.shape[:2]
    q = torch.cat([q_nope, q_rope], dim=-1)  # (B,S,H,dn+dr)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(q_rope.shape)], dim=-1)
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    vpad = torch.nn.functional.pad(v, (0, dq - m.v_head_dim))
    out = causal_attention(q.reshape(B, S, H, 1, dq), k, vpad, positions, positions)
    out = out.reshape(B, S, H, dq)[..., : m.v_head_dim]
    return torch.einsum("bshk,hkd->bsd", out, p["wo_attn"])


def mla_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, cache_len: int):
    """Prefill: -> (out (B,S,D), cache {ckv, kr, pos} padded to cache_len)."""
    latents = _latents(p, x, cfg, positions)
    out = mla_train(p, x, positions, cfg, latents)
    _, _, c_kv, k_rope = latents
    pad = cache_len - x.shape[1]
    cache = {
        "ckv": torch.nn.functional.pad(c_kv, (0, 0, 0, pad)),
        "kr": torch.nn.functional.pad(k_rope, (0, 0, 0, pad)),
        "pos": torch.nn.functional.pad(positions.to(torch.int32), (0, pad), value=-1),
    }
    return out, cache


def mla_decode(p, x: torch.Tensor, pos: int, cache: dict, cfg: ArchConfig):
    """Absorbed one-token decode against the latent cache: x (B,1,D) ->
    (out, cache).  Writes the token's latent, rope key and position into
    ``cache`` in place (the reference returns a new cache)."""
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _latents(p, x, cfg, positions)
    cache["ckv"][:, pos] = c_new[:, 0]
    cache["kr"][:, pos] = kr_new[:, 0]
    cache["pos"][:, pos] = pos
    ckv, kr, pc = cache["ckv"], cache["kr"], cache["pos"]
    # absorb W_uk: q_abs (B,1,H,r) = q_nope @ W_uk^T
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())) * scale
    valid = (pc >= 0) & (pc <= pos)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    # attend against the latent, then absorb W_uv
    o_lat = torch.einsum("bhst,btr->bshr", w.to(ckv.dtype), ckv)
    out = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"])
    return torch.einsum("bshk,hkd->bsd", out, p["wo_attn"]), cache


def init_mla_cache(cfg: ArchConfig, batch: int, cache_len: int, device) -> dict:
    """Empty latent cache: ckv (B,T,r) and kr (B,T,dr) zeros, pos (B,T) -1."""
    m = cfg.mla
    dt = torch_dtype(cfg.dtype)
    return {
        "ckv": torch.zeros(batch, cache_len, m.kv_lora_rank, dtype=dt, device=device),
        "kr": torch.zeros(batch, cache_len, m.qk_rope_head_dim, dtype=dt, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }
