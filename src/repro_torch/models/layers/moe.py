"""Mixture-of-Experts layer with the BinomialHash router — the counterpart
of ``repro.models.layers.moe`` on one device.

Routers:
* ``hash`` — **the paper's technique**: each token's id, salted per layer
  and per choice k, is a u32 key routed to an expert by a consistent-hash
  lookup (``router_keys``).  The lookup is the engine's static-n kernel
  (``make_bulk(router_hash_engine).kernels.lookup_vec``, the port of
  ``binomial_hash.py``'s ``_kernel``), or with ``router_dynamic_n`` its
  dynamic-n kernel; on CPU tensors their plain versions run.
* ``topk`` — softmax top-k with the Switch load-balancing aux loss.

The ``sigmoid`` router (DeepSeek-V3) and shared experts are not ported yet
and raise; ``apply_moe`` is the reference's unmeshed branch (the
expert-parallel mesh branch waits for ROADMAP Queue 1, item 13).

Dispatch is sort-based: assignments are stably sorted by expert id, ranked
within their expert, and the first ``C`` of each expert (``_capacity``) are
gathered into a fixed ``(E, C, D)`` buffer; the rest are dropped, exactly
as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.binomial_torch import GOLDEN32, MASK32, mix32, u32
from repro_torch.core.registry import make_bulk
from repro_torch.models.layers.common import dense_init, not_ported, torch_dtype


def check_supported(cfg: ArchConfig) -> None:
    m = cfg.moe
    if m.router not in ("hash", "topk"):
        raise not_ported(f"the {m.router!r} MoE router (DeepSeek-V3)")
    if m.shared_experts > 0:
        raise not_ported("shared experts (DeepSeek-V3)")


def init_moe(gen, cfg: ArchConfig) -> dict:
    check_supported(cfg)
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    dt = torch_dtype(cfg.param_dtype)
    return {
        "router": dense_init(gen, (D, E), torch.float32, scale=0.006),
        "experts_wi": dense_init(gen, (E, D, Fe), dt),
        "experts_wg": dense_init(gen, (E, D, Fe), dt),
        "experts_wo": dense_init(gen, (E, Fe, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def router_keys(token_ids: torch.Tensor, layer_salt: int, top_k: int) -> torch.Tensor:
    """The hash router's u32 keys (as int64 values): token ids (B,S) ->
    ``mix32(token_id ^ salt(layer, k))`` (B,S,K), every product wrapping
    in u32 as the reference's does.  ``layer_salt`` is the absolute layer
    index."""
    salt0 = (layer_salt * 1000003) & MASK32
    k_salts = torch.arange(top_k, dtype=torch.int64, device=token_ids.device) * 7919 + 1
    salts = (((salt0 + k_salts) & MASK32) * GOLDEN32) & MASK32
    return mix32(u32(token_ids)[..., None] ^ salts)


def route(p, x: torch.Tensor, token_ids: torch.Tensor, layer_salt: int, cfg: ArchConfig):
    """-> expert_ids (B,S,K) int32, gates (B,S,K) f32, aux_loss (0-dim f32)."""
    check_supported(cfg)
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if m.router == "hash":
        kk = router_keys(token_ids, layer_salt, K).to(torch.int32)  # u32 bit patterns
        kernels = make_bulk(m.router_hash_engine).kernels
        if m.router_dynamic_n:
            n = torch.tensor([E], dtype=torch.int32, device=kk.device)
            expert_ids = kernels.lookup_dyn(kk, n, m.router_hash_omega)
        else:
            expert_ids = kernels.lookup_vec(kk, E, m.router_hash_omega)
        return expert_ids, torch.full(expert_ids.shape, 1.0 / K, device=x.device), zero

    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    g, expert_ids = torch.topk(probs, K, dim=-1)
    gates = g / g.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch-style load-balance loss
    me = probs.reshape(-1, E).mean(0)
    onehot = F.one_hot(expert_ids.reshape(-1), E).float()
    ce = (onehot.amax(1)[:, None] * onehot).mean(0) * E
    aux = m.aux_loss_weight * E * (me * ce).sum()
    return expert_ids.to(torch.int32), gates, aux


# ---------------------------------------------------------------------------
# sort-based local dispatch
# ---------------------------------------------------------------------------


def _expert_ffn(buf, wi, wg, wo):
    h = F.silu(torch.bmm(buf, wi)) * torch.bmm(buf, wg)
    return torch.bmm(h, wo)


def _routing_plan(expert_ids, gates, e_offset: int, E_local: int, C: int, N: int, K: int):
    """Sort-based assignment plan for the local expert slice."""
    flat_e = expert_ids.reshape(-1).long()
    flat_g = gates.reshape(-1)
    arange = torch.arange(N * K, device=flat_e.device)
    tok = arange // K

    local = (flat_e >= e_offset) & (flat_e < e_offset + E_local)
    le = torch.where(local, flat_e - e_offset, E_local)  # E_local = overflow bin
    order = torch.argsort(le, stable=True)
    se, stok, sg = le[order], tok[order], flat_g[order]

    offsets = torch.searchsorted(se, torch.arange(E_local, device=se.device))
    rank = arange - offsets[se.clamp(0, E_local - 1)]
    keep = (se < E_local) & (rank < C)
    slot = torch.where(keep, se * C + rank, E_local * C)  # last row = dump slot
    return slot, stok, sg, keep


def _scatter_buf(x_flat, slot, stok, keep, E_local: int, C: int):
    buf = torch.zeros(E_local * C + 1, x_flat.shape[-1], dtype=x_flat.dtype, device=x_flat.device)
    return buf.index_add_(0, slot, x_flat[stok] * keep[:, None].to(x_flat.dtype))


def _combine(out_buf_flat, slot, stok, sg, keep, N: int, dtype):
    contrib = out_buf_flat[slot.clamp(0, out_buf_flat.shape[0] - 1)]
    w = (sg * keep).to(dtype)[:, None]
    y = torch.zeros(N, out_buf_flat.shape[-1], dtype=dtype, device=out_buf_flat.device)
    return y.index_add_(0, stok, contrib * w)


def _dispatch_local(x_flat, expert_ids, gates, wi, wg, wo, e_offset: int, E_local: int, C: int):
    """x_flat (N,D); expert_ids/gates (N,K); weights local (E_local,...).

    Gather and scatter touch only the E_local*C buffer rows (the kept
    assignments), not all N*K assignment slots."""
    N, D = x_flat.shape
    K = expert_ids.shape[-1]
    slot, stok, sg, keep = _routing_plan(expert_ids, gates, e_offset, E_local, C, N, K)
    # invert slot -> source assignment (kept slots are collision-free; the
    # dump slot, written many times, is cut off)
    src = torch.full((E_local * C + 1,), -1, dtype=torch.int64, device=x_flat.device)
    src[slot] = torch.arange(N * K, device=x_flat.device)
    src = src[: E_local * C]
    valid = src >= 0
    srcc = src.clamp(min=0)
    rows = x_flat[stok[srcc]] * valid[:, None].to(x_flat.dtype)
    out_buf = _expert_ffn(rows.reshape(E_local, C, D), wi, wg, wo).reshape(E_local * C, D)
    w = (sg[srcc] * valid).to(x_flat.dtype)
    y = torch.zeros(N + 1, D, dtype=x_flat.dtype, device=x_flat.device)  # row N: dropped
    y.index_add_(0, torch.where(valid, stok[srcc], N), out_buf * w[:, None])
    return y[:N]


def _capacity(cfg: ArchConfig, n_local_tokens: int) -> int:
    m = cfg.moe
    return max(1, int(m.capacity_factor * n_local_tokens * m.top_k / m.num_experts))


# ---------------------------------------------------------------------------
# full layer
# ---------------------------------------------------------------------------


def apply_moe(p, x: torch.Tensor, token_ids: torch.Tensor, layer_salt: int, cfg: ArchConfig):
    """x (B,S,D) -> (B,S,D), aux_loss.  token_ids (B,S) (hash router)."""
    m = cfg.moe
    B, S, D = x.shape
    expert_ids, gates, aux = route(p, x, token_ids, layer_salt, cfg)
    y = _dispatch_local(
        x.reshape(-1, D), expert_ids.reshape(-1, m.top_k), gates.reshape(-1, m.top_k),
        p["experts_wi"], p["experts_wg"], p["experts_wo"], 0, m.num_experts,
        _capacity(cfg, B * S),
    )
    return y.reshape(B, S, D), aux
