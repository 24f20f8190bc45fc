"""Mixture-of-Experts layer with the BinomialHash router — the counterpart
of ``repro.models.layers.moe`` on one device.

Routers:
* ``hash`` — **the paper's technique**: each token's id, salted per layer
  and per choice k, is a u32 key routed to an expert by a consistent-hash
  lookup (``router_keys``).  The lookup is the engine's static-n kernel
  (``make_bulk(router_hash_engine).kernels.lookup_router``, the port of
  ``binomial_hash.py``'s ``_kernel`` over keys it builds from the token ids
  in the same launch), or with ``router_dynamic_n`` the dynamic-n kernel
  over ``router_keys``; on CPU tensors their plain versions run, and on
  ``meta`` tensors (the dry run) nothing does: the ids are a ``meta``
  tensor of their shape.
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

Under a mesh (``repro_torch.sharding.rules.mesh_context`` with a
``DeviceMesh``) each rank passes its data shard of the tokens (the batch
block ``batch_pspecs`` gives it; the same on every rank of a ``model``
group) and holds its block of the expert weights (``params_pspecs`` under
the active ``fsdp`` and expert layout), and gets its shard of the output.
Which branch runs follows the reference: with few tokens per expert
(``n_local * top_k <= 4 * num_experts``, ``n_local`` this shard's token
count) the dense GShard path, else the expert-parallel (EP) body:

* the EP body is the reference's ``shard_map`` body as per-rank code: the
  sort-based dispatch of this shard's tokens to the rank's experts with the
  per-shard capacity ``_capacity(cfg, n_local)``, the expert weights
  all-gathered over ``data`` under fsdp, the partial outputs summed over
  ``model``;
* the dense path ranks every expert's assignments over the *global* token
  order with the global capacity, as the reference's masks over the whole
  batch do: the shards' tokens, expert ids and gates are gathered over the
  data axes (a few rows at decode), and the weights stay sharded — the
  partial products over a weight block are summed over the axis it is cut
  on.

The ``"ep"`` layout cuts the experts over ``model``, the ``"tp"`` layout
their ff width; both give the same sums.  Both branches are
differentiable: their collectives are ``repro_torch.sharding.rules``'
``copy_to``/``reduce_from``/``gather``, under the gradient convention
stated there (every rank backpropagates the loss replicated over it; a
shard's tokens carry its share of the gradient; the expert weights' blocks
get exactly their gradient, the router's replicated weights their data
shard's share, summed over ``data`` by the train step).

Dispatch is sort-based: assignments are stably sorted by expert id, ranked
within their expert, and the first ``C`` of each expert (``_capacity``) are
gathered into a fixed ``(E, C, D)`` buffer; the rest are dropped, exactly
as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules

from repro_torch.configs.base import ArchConfig
from repro_torch.core.binomial_torch import router_keys
from repro_torch.core.registry import make_bulk
from repro_torch.models.layers.common import (
    apply_mlp,
    dense_init,
    init_mlp,
    torch_dtype,
)


def check_supported(cfg: ArchConfig) -> None:
    if cfg.moe.router not in ("hash", "topk", "sigmoid"):
        raise ValueError(f"unknown MoE router {cfg.moe.router!r} (hash, topk or sigmoid)")


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
        if token_ids.device.type == "meta":  # the dry run: shapes, no values to route
            expert_ids = torch.empty((*token_ids.shape, K), dtype=torch.int32, device="meta")
        elif m.router_dynamic_n:
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
    if rules.current_mesh() is not None:  # means over the whole batch
        me, ce = _dp_mean(me), _dp_mean(ce)
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
# under a mesh
# ---------------------------------------------------------------------------


def _dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _dp_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of equal-sized shards' ``t`` over the data axes, a tensor
    replicated over them (its gradient reaches each shard's ``t`` divided
    by the shard count)."""
    return rules.dp_sum(t) / (rules.axis_size("pod") * rules.axis_size("data"))


def _dp_gather(t: torch.Tensor) -> torch.Tensor:
    """Every data shard's ``t`` along dim 0, in the global batch order
    (pod major); the gradient of the gathered rows is reduce-scattered
    back to their shards."""
    mesh = rules.current_mesh()
    for axis in reversed(_dp_axes(mesh)):
        t = rules.gather(t, axis, 0) if t.is_floating_point() else rules.all_gather(t, axis, 0)
    return t


def _gshard_masks(expert_ids, gates, E: int, C: int):
    """expert_ids/gates (N,K) -> dispatch (N,E,C) 0/1, combine (N,E,C):
    each expert takes its first ``C`` assignments in token order."""
    N, K = expert_ids.shape
    oh = F.one_hot(expert_ids.reshape(-1).long(), E).float()  # (N*K, E)
    pos = torch.cumsum(oh, 0) - oh
    rank = (pos * oh).sum(-1).long()
    keep = (rank < C).float()
    disp = oh * keep[:, None]
    disp_c = disp[:, :, None] * F.one_hot(rank.clamp(max=C - 1), C).float()[:, None, :]
    dispatch = disp_c.reshape(N, K, E, C).sum(1)
    combine = (disp_c * gates.reshape(-1).float()[:, None, None]).reshape(N, K, E, C).sum(1)
    return dispatch, combine


class _ExpertBlock:
    """The expert weights in the layout a mesh body computes with.

    The parameters arrive cut by ``params_pspecs`` under the active mesh
    context (where, the rules being first-match, ``experts_wi``/``wg``
    take the MLP rule and so cut their ff width over ``model``, while
    ``experts_wo`` cuts its experts).  The bodies want one cut for all
    three: the ``"ep"`` layout holds experts ``[e_offset, e_offset +
    E_local)`` whole, the ``"tp"`` layout every expert's ff block; the
    model width is cut over ``data`` only where ``keep_d`` (the dense
    path) and the parameters were cut so (fsdp).  ``rules.relayout``
    gathers what the body needs: each rank computes its part with a
    gathered weight, so the gradients of the gathers are reduce-scattered
    (summed), unless nothing is cut over ``model`` and every rank of a
    model group computes the whole layer alike."""

    def __init__(self, p, cfg: ArchConfig, keep_d: bool):
        m = cfg.moe
        E, D, Fe = m.num_experts, cfg.d_model, m.d_ff_expert
        mesh = rules.current_mesh()
        sizes = rules.layout(mesh).shape
        have_wi = rules.param_spec("experts_wi", (E, D, Fe))
        have_wo = rules.param_spec("experts_wo", (E, Fe, D))
        e = "model" if rules.expert_layout() == "ep" and E % sizes["model"] == 0 else None
        f = "model" if rules.expert_layout() == "tp" and Fe % sizes["model"] == 0 else None
        d = "data" if keep_d and have_wi[1] == "data" else None
        self.model_cut = (e is not None or f is not None) and sizes["model"] > 1
        whole = not self.model_cut
        self.wi = rules.relayout(p["experts_wi"], have_wi, (e, d, f), whole=whole)
        self.wg = rules.relayout(p["experts_wg"], rules.param_spec("experts_wg", (E, D, Fe)),
                                 (e, d, f), whole=whole)
        self.wo = rules.relayout(p["experts_wo"], have_wo, (e, f, d), whole=whole)
        self.E_local = E // sizes["model"] if e else E
        self.e_offset = rules.coordinate(mesh)["model"] * self.E_local if e else 0
        self.d_cut = d is not None
        self.d_index = rules.coordinate(mesh)["data"]

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor replicated over ``model`` entering the body, where each
        model rank computes its experts' or ff block's part."""
        return rules.copy_to(t, "model") if self.model_cut else t

    def sum_over_model(self, y: torch.Tensor) -> torch.Tensor:
        """Partial outputs over this rank's experts or ff block -> the sum."""
        return rules.reduce_from(y, "model") if self.model_cut else y


def _ep_moe(p, x_flat, expert_ids, gates, cfg: ArchConfig):
    """The EP body on this shard's tokens (N_local, D)."""
    blk = _ExpertBlock(p, cfg, keep_d=False)
    C = _capacity(cfg, x_flat.shape[0])
    y = _dispatch_local(blk.enter(x_flat), expert_ids, blk.enter(gates), blk.wi, blk.wg, blk.wo,
                        blk.e_offset, blk.E_local, C)
    return blk.sum_over_model(y)


def _dense_moe(p, x_flat, expert_ids, gates, cfg: ArchConfig):
    """The dense GShard path on this shard's tokens (N_local, D): masks
    over the global batch, the weights' model width left in its blocks.
    With the model width cut over ``data``, each data rank's products over
    its block are summed over ``data`` into activations every data rank
    uses for its own block (all-reduced both ways)."""
    m = cfg.moe
    blk = _ExpertBlock(p, cfg, keep_d=True)
    n_local = x_flat.shape[0]
    xg = _dp_gather(blk.enter(x_flat))
    eg, gg = _dp_gather(expert_ids), _dp_gather(blk.enter(gates))
    Cg = max(1, int(m.capacity_factor * xg.shape[0] * m.top_k / m.num_experts))
    dispatch, combine = _gshard_masks(eg, gg, m.num_experts, Cg)
    lo, hi = blk.e_offset, blk.e_offset + blk.E_local
    dispatch, combine = dispatch[:, lo:hi], combine[:, lo:hi]
    if blk.d_cut:  # this rank's block of the model width
        d = blk.wi.shape[1]
        xg = xg[:, blk.d_index * d:(blk.d_index + 1) * d]
    buf = torch.einsum("nec,nd->ecd", dispatch.to(xg.dtype), xg)
    h_in = torch.einsum("edf,ecd->efc", blk.wi, buf)
    h_gate = torch.einsum("edf,ecd->efc", blk.wg, buf)
    if blk.d_cut:
        h_in = rules.copy_to(rules.reduce_from(h_in, "data"), "data")
        h_gate = rules.copy_to(rules.reduce_from(h_gate, "data"), "data")
    out = torch.einsum("efd,efc->edc", blk.wo, F.silu(h_in) * h_gate)
    y = blk.sum_over_model(torch.einsum("edc,nec->nd", out, combine.to(xg.dtype)))
    if blk.d_cut:
        y = rules.gather(y, "data", 1)
    mesh = rules.current_mesh()
    index, _ = rules.block(_dp_axes(mesh), mesh, rules.coordinate(mesh))
    return y[index * n_local:(index + 1) * n_local]


def _mesh_moe(p, x, expert_ids, gates, cfg: ArchConfig) -> torch.Tensor:
    m = cfg.moe
    B, S, D = x.shape
    args = (x.reshape(-1, D), expert_ids.reshape(-1, m.top_k), gates.reshape(-1, m.top_k))
    if B * S * m.top_k <= 4 * m.num_experts:
        # few tokens per expert (decode, small serve batches): the weights'
        # model width stays in its blocks, only the few tokens move
        y = _dense_moe(p, *args, cfg)
    else:
        y = _ep_moe(p, *args, cfg)
    return y.reshape(B, S, D)


# ---------------------------------------------------------------------------
# full layer
# ---------------------------------------------------------------------------


def apply_moe(p, x: torch.Tensor, token_ids: torch.Tensor, layer_salt: int, cfg: ArchConfig):
    """x (B,S,D) -> (B,S,D), aux_loss.  token_ids (B,S) (hash router).
    Under a mesh, each of them is this rank's data shard."""
    m = cfg.moe
    B, S, D = x.shape
    expert_ids, gates, aux = route(p, x, token_ids, layer_salt, cfg)
    if rules.current_mesh() is not None:
        y = _mesh_moe(p, x, expert_ids, gates, cfg)
    else:
        y = _dispatch_local(
            x.reshape(-1, D), expert_ids.reshape(-1, m.top_k), gates.reshape(-1, m.top_k),
            p["experts_wi"], p["experts_wg"], p["experts_wo"], 0, m.num_experts,
            _capacity(cfg, B * S),
        ).reshape(B, S, D)
    if m.shared_experts > 0:
        y = y + apply_mlp(p["shared"], x, cfg, d_ff=m.shared_experts * m.d_ff_expert)
    return y, aux
