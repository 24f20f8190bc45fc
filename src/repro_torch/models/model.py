"""Model: init / prefill / cached decode — the counterpart of
``repro.models.model`` for serving.

Parameters are ``{"embed", "final_norm", "layers"}``: the reference's
embedding and final-norm dicts, and one block dict per layer in order (the
reference stacks each segment's layers along a scan axis; here a Python
loop runs over the layers).  The cache is ``{"cur": int, "layers": [...]}``
with one dict per layer (``{k, v, pos}`` for attention, ``{h, conv}`` for
RG-LRU, ``{state, conv}`` for SSD).

With ``mtp_depth > 0`` (DeepSeek-V3) ``init_params`` also builds the
reference's multi-token-prediction subtree ``params["mtp"]`` (two norms,
the ``(2D, D)`` input projection, one block and a final norm), so that
parameter trees and counts match; prefill and decode never read it, as in
the reference, and its loss comes with training.

Inputs are token ids (``{"tokens"}``) or, for the modality backbones,
embeddings: ``{"embeds" (B,S,D)}`` and, for M-RoPE, ``{"positions"
(3,B,S)}`` (a decode step takes ``{"embeds" (B,1,D)}``).  Sinusoidal
positions are added to the embedded inputs.  Training (the loss and its
backward) waits for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
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
)


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


def params_to(params, device) -> dict:
    """A copy of ``params`` on ``device``."""
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, list):
            return [move(v) for v in x]
        return x.to(device)

    return move(params)


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
