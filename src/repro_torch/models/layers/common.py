"""Shared layer primitives: norms, MLPs, rope, embeddings and init — the
counterparts of ``repro.models.layers.common``.

Parameters are plain dicts of tensors with the JAX package's names and
layouts; init draws from an explicit ``torch.Generator`` on its device.

Under a mesh (``repro_torch.sharding.rules.mesh_context`` with a
``DeviceMesh``) each rank holds its block of every weight, cut by
``params_pspecs``, and its data shard of the activations, replicated over
``model``; with no mesh every helper below is the plain computation.
Each weight is gathered over ``data`` where fsdp cuts it, at its use
(``rules.weight``; the backward reduce-scatters its gradient), and the
layers are Megatron's where the model axis cuts them:

* ``embed_tokens``: vocab-parallel — each rank looks up the tokens of its
  block of the vocabulary, zeros elsewhere, summed over ``model``;
* ``apply_mlp``: ``wi``/``wg`` column-parallel, ``wo_mlp`` row-parallel,
  the partial outputs summed over ``model``;
* ``unembed``: the logits of the rank's block of the (padded) vocabulary,
  which ``repro_torch.models.model.chunked_ce`` reduces over ``model``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding import rules


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


#: a draw of more elements than this is made in slices along its first
#: axis, so that its float32 draw never holds more than 1 GiB beside the
#: result (a full-width MoE layer's (256, 7168, 2048) experts would
#: otherwise hold 15 GB of float32 for a 7.5 GB bf16 tensor)
DRAW_SLICE = 1 << 28


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes and dtypes are
    wanted: ``init_params(MetaGenerator(), cfg)`` builds every leaf as a
    ``meta`` tensor, with no storage and no draw."""

    device = torch.device("meta")


def draw_generator(gen):
    """The ``generator=`` argument of a draw from ``gen`` (none on meta)."""
    return None if gen.device.type == "meta" else gen


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 0.02) -> torch.Tensor:
    """A standard normal draw times ``scale``, made in float32 on the
    generator's device and cast to ``dtype`` (in slices along the first
    axis past ``DRAW_SLICE`` elements); a ``meta`` tensor from a
    ``MetaGenerator``."""
    shape = tuple(shape)
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    numel = int(np.prod(shape))
    if numel <= DRAW_SLICE or len(shape) < 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, DRAW_SLICE // (numel // shape[0]))
    for i in range(0, shape[0], rows):
        part = torch.randn((min(rows, shape[0] - i), *shape[1:]), generator=gen,
                           dtype=torch.float32, device=gen.device)
        out[i:i + part.shape[0]] = part.mul_(scale)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, dim: int, device) -> dict:
    p = {"scale": torch.ones(dim, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm" and cfg.norm_bias:
        p["bias"] = torch.zeros(dim, dtype=torch.float32, device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"]
        if "bias" in p:
            out = out + p["bias"]
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm (qk-norm); scale has shape (head_dim,)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs — swiglu | geglu | gelu
# ---------------------------------------------------------------------------


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default


def init_mlp(gen, cfg: ArchConfig, d_model: int | None = None, d_ff: int | None = None) -> dict:
    D = d_model or cfg.d_model
    Fd = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    p = {"wi": dense_init(gen, (D, Fd), dt), "wo_mlp": dense_init(gen, (Fd, D), dt)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (D, Fd), dt)
    if cfg.mlp_bias:
        p["bi"] = torch.zeros(Fd, dtype=dt, device=gen.device)
        p["bo"] = torch.zeros(D, dtype=dt, device=gen.device)
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig, d_ff: int | None = None) -> torch.Tensor:
    """x (..., D) -> (..., D); ``d_ff`` the full hidden width (``cfg.d_ff``
    unless given), which the rules need under a mesh."""
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    cut = rules.model_cut("wi", (D, Fd), 1)
    wi = rules.weight(p, "wi", (D, Fd), (None, cut))
    wo = rules.weight(p, "wo_mlp", (Fd, D), (cut, None))
    if cut:
        x = rules.copy_to(x, cut)
    h = x @ wi
    if cfg.mlp_bias:
        h = h + rules.part(p["bi"], 0, cut)
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ rules.weight(p, "wg", (D, Fd), (None, cut))
        h = (F.silu(h) if cfg.mlp == "swiglu" else _gelu(h)) * g
    else:
        h = _gelu(h)
    out = h @ wo
    if cut:
        out = rules.reduce_from(out, cut)
    if cfg.mlp_bias:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# depthwise causal conv (RG-LRU and SSD blocks)
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """x (B,S,C); w (cw,C) depthwise causal conv; state (B,cw-1,C) or None
    (zeros). -> (out (B,S,C), the last cw-1 inputs as the next state).  The
    reference's ``_causal_conv`` of ``rglru.py`` and ``ssd.py``."""
    cw = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+cw-1, C)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw)) + b
    new_state = xp[:, -(cw - 1):] if cw > 1 else torch.zeros_like(pad)
    return out, new_state


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _rope_freqs(dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim/2) in fp32."""
    freqs = torch.from_numpy(_rope_freqs(dim, theta)).to(positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3: torch.Tensor, dim: int, theta: float, sections: tuple[int, ...]):
    """M-RoPE (Qwen2-VL): positions3 (3, ..., S); ``sections`` sum to dim/2.
    -> cos/sin (..., S, dim/2) in fp32, each section of frequencies taken
    from its own (temporal, height, width) position stream."""
    freqs = torch.from_numpy(_rope_freqs(dim, theta)).to(positions3.device)
    ang = positions3[..., None].float() * freqs  # (3, ..., S, dim/2)
    pieces, off = [], 0
    for stream, sec in enumerate(sections):
        pieces.append(ang[stream, ..., off:off + sec])
        off += sec
    ang = torch.cat(pieces, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def sinusoidal_pos_emb(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """The classic transformer sinusoid table at ``positions`` (..., S)
    -> (..., S, dim) fp32: sines, then cosines."""
    half = dim // 2
    freqs = torch.from_numpy(
        1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) / half))
    ).to(positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(x: torch.Tensor, cos, sin, fraction: float = 1.0) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, d2). Rotates the first
    ``fraction`` of the head dim (pairwise split-half convention)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    d2 = rot // 2
    c = cos[..., :d2][..., :, None, :]  # broadcast over heads
    s = sin[..., :d2][..., :, None, :]
    xf1, xf2 = xr[..., :d2].float(), xr[..., d2:].float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def init_embeddings(gen, cfg: ArchConfig) -> dict:
    dt = torch_dtype(cfg.param_dtype)
    p = {"embedding": dense_init(gen, (cfg.padded_vocab, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt)
    return p


def vocab_block(cfg: ArchConfig) -> tuple[int, int, str | None]:
    """-> ``(first, size, axis)``: the rank's block of the padded
    vocabulary (the embedding's rows, the unembedding's columns) and the
    axis that cuts it (``None``: the whole vocabulary)."""
    V = cfg.padded_vocab
    cut = rules.model_cut("embedding", (V, cfg.d_model), 0)
    if cut is None:
        return 0, V, None
    n = V // rules.axis_size(cut)
    return rules.axis_index(cut) * n, n, cut


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    V, D = cfg.padded_vocab, cfg.d_model
    lo, n, cut = vocab_block(cfg)
    emb = rules.weight(p, "embedding", (V, D), (cut, None))
    if cut is None:
        return emb[tokens].to(torch_dtype(cfg.dtype))
    local = tokens - lo
    mine = (local >= 0) & (local < n)
    x = emb[local.clamp(0, n - 1)] * mine[..., None].to(emb.dtype)
    return rules.reduce_from(x, cut).to(torch_dtype(cfg.dtype))


def unembed(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """-> fp32 logits over the padded vocab (padded classes are ordinary,
    never-targeted logits, as in the reference); under a mesh whose model
    axis cuts the vocabulary, over the rank's block of it
    (``vocab_block``)."""
    V, D = cfg.padded_vocab, cfg.d_model
    _, _, cut = vocab_block(cfg)
    if cut:
        x = rules.copy_to(x, cut)
    if cfg.tie_embeddings:
        logits = x @ rules.weight(p, "embedding", (V, D), (cut, None)).T
    else:
        logits = x @ rules.weight(p, "unembed", (D, V), (None, cut))
    return logits.float()
