"""Model: init / training loss / prefill / cached decode — the
counterpart of ``repro.models.model``.

Serving takes parameters ``{"embed", "final_norm", "layers"}``: the
reference's embedding and final-norm dicts, and one block dict per layer in
order.  The cache is ``{"cur": int, "layers": [...]}`` with one dict per
layer (``{k, v, pos}`` for attention, ``{h, conv}`` for RG-LRU, ``{state,
conv}`` for SSD).

Training holds the reference's stacked layout, ``{"embed", "final_norm",
"seg{i}": {"sub{j}": leaves of shape (count, ...)}}`` (``stack_layers``;
``per_layer`` gives the serving layout as views of it), because the
reference's Adafactor, gradient compression and checkpoint keys all work
per stacked leaf.  ``loss_fn`` runs the layers in a Python loop over views
of the stacked leaves (one ``unbind`` per segment), so autograd
accumulates each layer's gradient into its stacked leaf with no copy of
the parameters.  ``cfg.remat`` picks the reference's rematerialisation:
``"full"`` checkpoints each scan step and each cross-entropy chunk
(``torch.utils.checkpoint``, non-reentrant); ``"dots"`` saves only the
matrix products' outputs (selective checkpointing); recomputation runs the
same operators on the same inputs, so all three give the same numbers.
The MoE router runs again in each recomputation (one more hash-router
launch per MoE layer).

With ``mtp_depth > 0`` (DeepSeek-V3) ``init_params`` also builds the
reference's multi-token-prediction subtree ``params["mtp"]`` (two norms,
the ``(2D, D)`` input projection, one block and a final norm); prefill and
decode never read it, and the loss adds ``0.3 *`` its cross entropy on
the next-but-one token, as the reference's does.

Inputs are token ids (``{"tokens"}``) or, for the modality backbones,
embeddings: ``{"embeds" (B,S,D)}`` and, for M-RoPE, ``{"positions"
(3,B,S)}`` (a decode step takes ``{"embeds" (B,1,D)}``); training batches
add ``{"targets" (B,S)}``, -1 for no target.  Sinusoidal positions are
added to the embedded inputs.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers.common import (
    apply_norm,
    dense_init,
    embed_tokens,
    init_embeddings,
    init_norm,
    sinusoidal_pos_emb,
    torch_dtype,
    unembed,
    vocab_block,
)
from repro_torch.sharding import rules
from repro_torch.tree import leaves, tree_map, unflatten


def init_mtp(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """The multi-token-prediction module's parameters (the reference's
    ``params["mtp"]``)."""
    D = cfg.d_model
    dev = gen.device
    return {
        "norm_h": init_norm(cfg, D, dev),
        "norm_e": init_norm(cfg, D, dev),
        "in_proj_mtp": dense_init(gen, (2 * D, D), torch_dtype(cfg.param_dtype)),
        "block": B.init_block(gen, "attn_moe" if cfg.moe else "attn", cfg),
        "final_norm": init_norm(cfg, D, dev),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on the generator's device, drawn from it in order
    (embeddings, then layer by layer, then the MTP module where
    ``mtp_depth > 0``)."""
    params = {
        "embed": init_embeddings(gen, cfg),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
        "layers": [B.init_block(gen, kind, cfg) for kind in cfg.layer_kinds()],
    }
    if cfg.mtp_depth > 0:
        params["mtp"] = init_mtp(gen, cfg)
    return params


def stack_layers(params, cfg: ArchConfig) -> dict:
    """Per-layer parameters -> the reference's stacked layout: each
    segment's layers stacked along a new first axis, ``params["seg{i}"]
    ["sub{j}"]``, step ``s`` holding layer ``seg.base + s * len(seg.unit)
    + j`` (a copy)."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for i, seg in enumerate(B.build_segments(cfg)):
        out[f"seg{i}"] = {
            f"sub{j}": tree_map(lambda *ls: torch.stack(ls),
                                *(params["layers"][B.layer_index(seg, s, j)] for s in range(seg.count)))
            for j in range(len(seg.unit))
        }
    if "mtp" in params:
        out["mtp"] = params["mtp"]
    return out


def per_layer(params, cfg: ArchConfig) -> dict:
    """The stacked layout -> ``{"embed", "final_norm", "layers"}`` (and
    ``"mtp"``) for ``prefill`` and ``decode_step``: each layer's leaves are
    views ``leaf[s]`` of the stacked leaves, no copy."""
    layers: list = [None] * cfg.num_layers
    for i, seg in enumerate(B.build_segments(cfg)):
        for j in range(len(seg.unit)):
            for s, layer in enumerate(_unbind(params[f"seg{i}"][f"sub{j}"], seg.count)):
                layers[B.layer_index(seg, s, j)] = layer
    out = {"embed": params["embed"], "final_norm": params["final_norm"], "layers": layers}
    if "mtp" in params:
        out["mtp"] = params["mtp"]
    return out


def init_train_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """``init_params`` in the stacked layout of training."""
    return stack_layers(init_params(gen, cfg), cfg)


def count_params(params) -> int:
    return int(sum(leaf.numel() for leaf in leaves(params)))


def active_params(cfg: ArchConfig, params) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    total = count_params(params)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = cfg.d_model * m.d_ff_expert * 3
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k == "attn_moe")
    if cfg.mtp_depth > 0:
        n_moe_layers += 1
    return total - n_moe_layers * (m.num_experts - m.top_k) * per_expert


def params_to(params, device) -> dict:
    """A copy of ``params`` on ``device``."""
    return tree_map(lambda t: t.to(device), params)


def _embed_inputs(params, batch, cfg: ArchConfig):
    """-> x (B,S,D), positions ((B,S), or (3,B,S) for M-RoPE), token_ids
    (B,S): the batch's tokens (or, for embeds inputs, its ``tokens`` or
    ``targets`` where it has them, else zeros)."""
    if cfg.input_mode == "tokens":
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
        Bsz, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(Bsz, S)
        token_ids = tokens
    else:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
        Bsz, S = x.shape[:2]
        token_ids = batch.get("tokens", batch.get("targets"))
        if token_ids is None:
            token_ids = torch.zeros((Bsz, S), dtype=torch.int32, device=x.device)
        if cfg.input_mode == "embeds_mrope":
            positions = batch["positions"]
        else:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(Bsz, S)
    if cfg.pos_emb == "sinusoidal":
        pos1 = positions if positions.ndim == 2 else positions[-1]
        x = x + sinusoidal_pos_emb(pos1, cfg.d_model).to(x.dtype)
    return x, positions, token_ids


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------

#: the products ``"dots"`` remat saves (``jax.checkpoint_policies
#: .checkpoint_dots``); every other output is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat``: ``"none"`` as it is, ``"full"``
    checkpointed (its inputs kept, the rest recomputed in the backward),
    ``"dots"`` keeping the matrix products' outputs too."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    context_fn = noop_context_fn
    if cfg.remat == "dots":
        def context_fn():
            return create_selective_checkpoint_contexts(_save_dots)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return remat


def _unbind(sub, count: int) -> list:
    """A stacked sub-block's tree -> one tree of views per scan step (one
    ``unbind`` per leaf, whose backward stacks the steps' gradients)."""
    flat = leaves(sub)
    views = [leaf.unbind(0) for leaf in flat]
    return [unflatten(sub, [v[s] for v in views]) for s in range(count)]


def trunk_train(params, batch, cfg: ArchConfig):
    """-> (hidden (B,S,D) after the final norm, aux loss, positions,
    token ids), over the stacked parameters."""
    x, positions, token_ids = _embed_inputs(params, batch, cfg)
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, seg in enumerate(B.build_segments(cfg)):
        steps = [_unbind(params[f"seg{i}"][f"sub{j}"], seg.count) for j in range(len(seg.unit))]

        def unit_fn(x, step, seg=seg, steps=steps):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for j, kind in enumerate(seg.unit):
                p = steps[j][step]
                x, a = B.block_train(p, kind, x, positions, token_ids, B.layer_index(seg, step, j), cfg)
                aux = aux + a
            return x, aux

        unit = _remat(unit_fn, cfg)
        seg_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for step in range(seg.count):
            x, aux = unit(x, step)
            seg_aux = seg_aux + aux
        aux_tot = aux_tot + seg_aux
    return apply_norm(params["final_norm"], x, cfg), aux_tot, positions, token_ids


def chunked_ce(params, hidden, targets, cfg: ArchConfig, chunk: int = 512) -> torch.Tensor:
    """Mean cross entropy over the valid (target >= 0) tokens; the vocab
    logits (f32) of one chunk of the sequence at a time, the chunk the
    largest divisor of S up to ``chunk`` and each one's loss under
    ``_remat``.

    Under a mesh ``hidden`` and ``targets`` are the rank's data shard and
    the mean is over the global batch (the sums and counts over the data
    axes).  Where the model axis cuts the vocabulary, each rank holds the
    logits of its block of it (``common.unembed``): the log-sum-exp takes
    the maximum and the sum of ``exp`` over ``model``, and the target's
    logit comes from the rank whose block holds it.  The padded classes
    are ordinary logits there too, as in the reference."""
    Bsz, S, D = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    lo, n, cut = vocab_block(cfg)

    def chunk_loss(h_c, t_c):
        logits = unembed(params["embed"], h_c, cfg)  # f32 (B,c,V) or the rank's block
        if cut is None:
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, t_c.clamp(min=0).long()[..., None])[..., 0]
        else:
            m = rules.all_reduce_max(logits.detach().amax(-1), cut)
            lse = m + torch.log(rules.reduce_from(torch.exp(logits - m[..., None]).sum(-1), cut))
            local = t_c.long() - lo
            mine = ((local >= 0) & (local < n)).float()
            ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0] * mine
            ll = rules.reduce_from(ll, cut)
        valid = (t_c >= 0).float()
        return ((lse - ll) * valid).sum(), valid.sum()

    chunk_loss = _remat(chunk_loss, cfg)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo_s in range(0, S, chunk):
        loss, c = chunk_loss(hidden[:, lo_s:lo_s + chunk], targets[:, lo_s:lo_s + chunk])
        tot, cnt = tot + loss, cnt + c
    tot = rules.dp_sum(tot)  # each is itself with no mesh
    for axis in ("pod", "data"):
        cnt = rules.all_reduce(cnt, axis)
    return tot / cnt.clamp(min=1.0)


def loss_fn(params, batch, cfg: ArchConfig):
    """-> (loss, metrics {ce, aux, [mtp_ce], loss}) over the stacked
    parameters: the mean cross entropy plus the MoE aux loss, plus ``0.3 *
    mtp_ce`` where the model has an MTP module (its block at salt 9999).

    Under a mesh (``rules.mesh_context`` with a ``DeviceMesh``) ``params``
    are this rank's blocks and ``batch`` its data shard; the loss is the
    global mean, the same on every rank, and its backward gives each rank
    its blocks' gradients (its data shard's share where a leaf is
    replicated over the data axes; ``repro_torch.training.train_step``
    sums those)."""
    hidden, aux, positions, token_ids = trunk_train(params, batch, cfg)
    targets = batch["targets"]
    ce = chunked_ce(params, hidden, targets, cfg)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth > 0 and "mtp" in params:
        mtp = params["mtp"]
        D = cfg.d_model
        emb = embed_tokens(params["embed"], batch["tokens"], cfg)
        emb_next = torch.nn.functional.pad(emb[:, 1:], (0, 0, 0, 1))
        h_in = torch.cat([apply_norm(mtp["norm_h"], hidden, cfg),
                          apply_norm(mtp["norm_e"], emb_next, cfg)], dim=-1)
        h_in = h_in @ rules.weight(mtp, "in_proj_mtp", (2 * D, D))
        kind = "attn_moe" if cfg.moe else "attn"
        h_mtp, _ = B.block_train(mtp["block"], kind, h_in, positions, token_ids, 9999, cfg)
        h_mtp = apply_norm(mtp["final_norm"], h_mtp, cfg)
        t_mtp = torch.nn.functional.pad(targets[:, 1:], (0, 1), value=-1)
        mtp_ce = chunked_ce(params, h_mtp, t_mtp, cfg)
        loss = loss + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    return {
        "cur": 0,
        "layers": [
            B.init_block_cache(kind, cfg, batch, B.block_cache_len(kind, cfg, max_len), device)
            for kind in cfg.layer_kinds()
        ],
    }


def prefill(params, batch, cfg: ArchConfig, max_len: int):
    """-> (cache, last-token logits (B, V))."""
    x, positions, token_ids = _embed_inputs(params, batch, cfg)
    caches = []
    for salt, (kind, p) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        x, c, _ = B.block_prefill(
            p, kind, x, positions, token_ids, salt, cfg, B.block_cache_len(kind, cfg, max_len)
        )
        caches.append(c)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    return {"cur": x.shape[1], "layers": caches}, logits


def decode_step(params, cache, batch, cfg: ArchConfig):
    """One token for the whole batch: ``{"tokens" (B,1)}`` or ``{"embeds"
    (B,1,D)}`` -> (cache, logits (B, V)).  The layer caches are updated in
    place."""
    pos = cache["cur"]
    if cfg.input_mode == "tokens":
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
    else:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
        tokens = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    if cfg.pos_emb == "sinusoidal":
        pos1 = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
        x = x + sinusoidal_pos_emb(pos1, cfg.d_model).to(x.dtype)
    for salt, (kind, p, c) in enumerate(zip(cfg.layer_kinds(), params["layers"], cache["layers"])):
        x, _ = B.block_decode(p, kind, x, pos, c, tokens, salt, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = unembed(params["embed"], x, cfg)[:, 0]
    return {"cur": pos + 1, "layers": cache["layers"]}, logits


# ---------------------------------------------------------------------------
# input and cache specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The batch of ``shape`` as ``meta`` tensors with the reference's
    shapes and dtypes (its ``input_specs``' ``ShapeDtypeStruct``s)."""
    Bsz = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1

    def f(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        if cfg.input_mode == "tokens":
            return {"tokens": f((Bsz, 1), i32)}
        return {"embeds": f((Bsz, 1, cfg.d_model), bf16)}
    batch = ({"tokens": f((Bsz, S), i32)} if cfg.input_mode == "tokens"
             else {"embeds": f((Bsz, S, cfg.d_model), bf16)})
    if cfg.input_mode == "embeds_mrope":
        batch["positions"] = f((3, Bsz, S), i32)
    if shape.kind == "train":
        batch["targets"] = f((Bsz, S), i32)
    return batch


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The reference's ``cache_specs``: its stacked decode cache for
    ``shape`` (``{"cur", "seg{i}": {"sub{j}": leaves (count, ...)}}``) as
    ``meta`` tensors, whole (no mesh)."""
    with rules.mesh_context(None):
        out = {"cur": torch.empty((), dtype=torch.int32, device="meta")}
        for i, seg in enumerate(B.build_segments(cfg)):
            out[f"seg{i}"] = {
                f"sub{j}": {
                    k: torch.empty((seg.count, *v.shape), dtype=v.dtype, device="meta")
                    for k, v in B.init_block_cache(kind, cfg, shape.global_batch,
                                                   B.block_cache_len(kind, cfg, shape.seq_len),
                                                   "meta").items()
                }
                for j, kind in enumerate(seg.unit)
            }
    return out
