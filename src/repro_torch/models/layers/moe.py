"""Mixture-of-Experts layer with the BinomialHash router — the counterpart
of ``repro.models.layers.moe`` on one device.

Routers:
* ``hash`` — **the paper's technique**: each token's id, salted per layer
  and per choice k, is a u32 key routed to an expert by a consistent-hash
  lookup (``router_keys``).  The lookup is the engine's static-n kernel
  (``make_bulk(router_hash_engine).kernels.lookup_router``, the port of
  ``binomial_hash.py``'s ``_kernel`` over keys it builds from the token ids
  in the same launch), or with ``router_dynamic_n`` the dynamic-n kernel
  over ``router_keys``; on CPU tensors their plain versions run.
* ``topk`` — softmax top-k with the Switch load-balancing aux loss.
* ``sigmoid`` — DeepSeek-V3's: sigmoid scores plus the selection bias
  ``router_bias`` pick the top k, the gates are the picked scores
  renormalised; no aux loss.

Both score routers pick their k experts with a stable descending sort,
so equal scores go to the lower expert id first, as ``lax.top_k`` orders
them (``torch.topk`` promises no order among ties), and gather the gates
from the scores.

Shared experts (``shared_experts > 0``) are one dense MLP of width
``shared_experts * d_ff_expert`` added to every token's output.
``apply_moe`` is the reference's unmeshed branch (the expert-parallel mesh
branch waits for the multi-device slice).

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
from repro_torch.core.binomial_torch import router_keys
from repro_torch.core.registry import make_bulk
from repro_torch.models.layers.common import (
    apply_mlp,
    dense_init,
    init_mlp,
    not_ported,
    torch_dtype,
)


def check_supported(cfg: ArchConfig) -> None:
    if cfg.moe.router not in ("hash", "topk", "sigmoid"):
        raise not_ported(f"the {cfg.moe.router!r} MoE router")


def init_moe(gen, cfg: ArchConfig) -> dict:
    check_supported(cfg)
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "router": dense_init(gen, (D, E), torch.float32, scale=0.006),
        "experts_wi": dense_init(gen, (E, D, Fe), dt),
        "experts_wg": dense_init(gen, (E, D, Fe), dt),
        "experts_wo": dense_init(gen, (E, Fe, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    if m.router == "sigmoid":
        p["router_bias"] = torch.zeros(E, dtype=torch.float32, device=gen.device)
    if m.shared_experts > 0:
        p["shared"] = init_mlp(gen, cfg, d_ff=m.shared_experts * Fe)
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The ids of the ``k`` largest scores along the last axis, in
    ``lax.top_k``'s order: descending, ties to the lower id."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def route(p, x: torch.Tensor, token_ids: torch.Tensor, layer_salt: int, cfg: ArchConfig):
    """-> expert_ids (B,S,K) int32, gates (B,S,K) f32, aux_loss (0-dim f32)."""
    check_supported(cfg)
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if m.router == "hash":
        kernels = make_bulk(m.router_hash_engine).kernels
        if m.router_dynamic_n:
            kk = router_keys(token_ids, layer_salt, K).to(torch.int32)  # u32 bit patterns
            n = torch.tensor([E], dtype=torch.int32, device=kk.device)
            expert_ids = kernels.lookup_dyn(kk, n, m.router_hash_omega)
        else:  # one launch builds the keys and looks them up
            expert_ids = kernels.lookup_router(token_ids.contiguous(), layer_salt, K, E,
                                               m.router_hash_omega)
        return expert_ids, torch.full(expert_ids.shape, 1.0 / K, device=x.device), zero

    logits = x.float() @ p["router"]
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
        expert_ids = _top_k(scores + p["router_bias"], K)
        g = torch.gather(scores, -1, expert_ids)
        gates = g / g.sum(-1, keepdim=True).clamp(min=1e-9)
        return expert_ids.to(torch.int32), gates, zero  # aux-loss-free (bias balancing)
    probs = torch.softmax(logits, dim=-1)
    expert_ids = _top_k(probs, K)
    g = torch.gather(probs, -1, expert_ids)
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
    ).reshape(B, S, D)
    if m.shared_experts > 0:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux
