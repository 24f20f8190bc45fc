"""Shared layer primitives: norms, MLPs, rope, embeddings and init — the
counterparts of ``repro.models.layers.common``.

Parameters are plain dicts of tensors with the JAX package's names and
layouts; init draws from an explicit ``torch.Generator`` on its device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    return getattr(torch, name)


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, item 11)")


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 0.02) -> torch.Tensor:
    """A standard normal draw times ``scale``, made in float32 on the
    generator's device and cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(scale).to(dtype)


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


def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_bias:
        h = h + p["bi"]
    if cfg.mlp == "swiglu":
        h = F.silu(h) * (x @ p["wg"])
    elif cfg.mlp == "geglu":
        h = _gelu(h) * (x @ p["wg"])
    else:
        h = _gelu(h)
    out = h @ p["wo_mlp"]
    if cfg.mlp_bias:
        out = out + p["bo"]
    return out


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


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return p["embedding"][tokens].to(torch_dtype(cfg.dtype))


def unembed(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """-> fp32 logits over the padded vocab (padded classes are ordinary,
    never-targeted logits, as in the reference)."""
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].T
    else:
        logits = x @ p["unembed"]
    return logits.float()
