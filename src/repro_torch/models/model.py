"""Model: init / prefill / cached decode — the counterpart of
``repro.models.model`` for serving.

Parameters are ``{"embed", "final_norm", "layers"}``: the reference's
embedding and final-norm dicts, and one block dict per layer in order (the
reference stacks each segment's layers along a scan axis; here a Python
loop runs over the layers).  The cache is ``{"cur": int, "layers": [...]}``
with one ``{k, v, pos}`` dict per layer.

Token inputs only; embeds inputs, sinusoidal positions and multi-token
prediction are not ported yet and raise.  Training (the loss and its
backward) waits for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers.common import (
    apply_norm,
    embed_tokens,
    init_embeddings,
    init_norm,
    not_ported,
    unembed,
)


def check_supported(cfg: ArchConfig) -> None:
    if cfg.input_mode != "tokens":
        raise not_ported(f"input_mode={cfg.input_mode!r}")
    if cfg.mtp_depth > 0:
        raise not_ported("multi-token prediction (DeepSeek-V3)")


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on the generator's device, drawn from it in order
    (embeddings, then layer by layer)."""
    check_supported(cfg)
    return {
        "embed": init_embeddings(gen, cfg),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
        "layers": [B.init_block(gen, kind, cfg) for kind in cfg.layer_kinds()],
    }


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
    """-> x (B,S,D), positions (B,S), token_ids (B,S)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    Bsz, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(Bsz, S)
    return x, positions, tokens


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
    """One token for the whole batch: tokens (B, 1) -> (cache, logits (B, V)).
    The layer caches are updated in place."""
    check_supported(cfg)
    pos = cache["cur"]
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    for salt, (kind, p, c) in enumerate(zip(cfg.layer_kinds(), params["layers"], cache["layers"])):
        x, _ = B.block_decode(p, kind, x, pos, c, tokens, salt, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = unembed(params["embed"], x, cfg)[:, 0]
    return {"cur": pos + 1, "layers": cache["layers"]}, logits
