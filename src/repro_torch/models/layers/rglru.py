"""RG-LRU recurrent block (Griffin / RecurrentGemma) — the counterpart of
``repro.models.layers.rglru``.

Block structure (per Griffin):
    x -> in_proj_y (D -> W) -> conv1d(width 4) -> RG-LRU -> *
    x -> in_proj_gate (D -> W) -> GeLU          ----------/
    * -> out_proj (W -> D)

RG-LRU recurrence (elementwise over the W channels):
    r_t = sigmoid(x_t @ gate_a + b_a)        recurrence gate
    i_t = sigmoid(x_t @ gate_x + b_x)        input gate
    a_t = exp(c * r_t * log(sigmoid(Λ)))     = a^(c·r_t), a = sigmoid(Λ)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t²) * (i_t * x_t)

Prefill runs the recurrence as a log-depth scan over (a_t, b_t) pairs in
float32 (``associative_scan``: the odd/even recursion of
``jax.lax.associative_scan``, so the pairs combine in the reference's
order); decode is one step with O(1) state, the cache ``{h (B,W) f32,
conv (B,cw-1,W)}``, which it updates in place.  The GeLU is the tanh
approximation, ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.common import _gelu, dense_init, draw_generator, torch_dtype
from repro_torch.models.layers.common import causal_conv as _causal_conv
from repro_torch.sharding import rules


def _width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, W = cfg.d_model, _width(cfg)
    cw = cfg.rglru.conv_width
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    # Λ init so that a = sigmoid(Λ) ∈ [0.9, 0.999] (Griffin appendix)
    u = torch.rand(W, generator=draw_generator(gen), dtype=torch.float32, device=dev) * (0.999 - 0.9) + 0.9
    uc = u ** (1.0 / cfg.rglru.c)
    return {
        "in_proj_y": dense_init(gen, (D, W), dt),
        "in_proj_gate": dense_init(gen, (D, W), dt),
        "conv_w": dense_init(gen, (cw, W), dt, scale=1.0 / math.sqrt(cw)),
        "conv_b": torch.zeros(W, dtype=dt, device=dev),
        "gate_a": dense_init(gen, (W, W), dt),
        "b_a": torch.zeros(W, dtype=torch.float32, device=dev),
        "gate_x": dense_init(gen, (W, W), dt),
        "b_x": torch.zeros(W, dtype=torch.float32, device=dev),
        "lam": torch.log(uc / (1 - uc)),
        "out_proj": dense_init(gen, (W, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _weights(p, cfg: ArchConfig) -> dict:
    """``p`` with the projections whole on this rank: under a mesh the
    rules cut ``in_proj_*`` (fsdp, tp) and ``out_proj`` (tp, fsdp), and
    every rank of a model group computes the whole mixer with them
    gathered (``rules.weight``), as ``ssd`` does; the reference constrains
    nothing inside the mixer."""
    D, W = cfg.d_model, _width(cfg)
    shapes = {"in_proj_y": (D, W), "in_proj_gate": (D, W), "out_proj": (W, D)}
    return {**p, **{n: rules.weight(p, n, shape) for n, shape in shapes.items()}}


def _gates(p, y: torch.Tensor, cfg: ArchConfig):
    """y (..., W) -> (a_t, beta_t * i_t * y_t) in fp32."""
    yf = y.float()
    r = torch.sigmoid(yf @ p["gate_a"].float() + p["b_a"])
    i = torch.sigmoid(yf @ p["gate_x"].float() + p["b_x"])
    log_a = cfg.rglru.c * r * F.logsigmoid(p["lam"])
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * yf


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs (a_t, b_t) under
    ``(al, bl) . (ar, br) = (al * ar, ar * bl + br)``: -> (prod a, h) with
    ``h_t = a_t * h_{t-1} + b_t``.  Log depth: adjacent pairs combine, the
    halved sequence is scanned recursively and the even positions are
    filled in from it, as ``jax.lax.associative_scan`` does."""
    n = a.shape[1]
    if n < 2:
        return a, b
    al, bl, ar, br = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = associative_scan(al * ar, ar * bl + br)
    if n % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    ea, eb = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * ea], dim=1)
    even_b = torch.cat([b[:, :1], ea * pb + eb], dim=1)
    out_a, out_b = a.new_empty(a.shape), b.new_empty(b.shape)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def rglru_scan(p, x: torch.Tensor, cfg: ArchConfig, h0=None, conv_state=None):
    """Full-sequence pass. x (B,S,D) -> (out (B,S,D), {h (B,W) f32, conv});
    ``h0`` (B,W) and ``conv_state`` carry a previous segment's state."""
    p = _weights(p, cfg)
    y = x @ p["in_proj_y"]
    gate = _gelu(x @ p["in_proj_gate"])
    y, conv_state = _causal_conv(y, p["conv_w"], p["conv_b"], conv_state)
    a, b = _gates(p, y, cfg)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    _, h = associative_scan(a, b)
    out = h.to(x.dtype) * gate
    return out @ p["out_proj"], {"h": h[:, -1], "conv": conv_state}


def rglru_decode(p, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-step decode. x (B,1,D); cache {h (B,W) f32, conv (B,cw-1,W)}.
    -> (out (B,1,D), cache), the cache updated in place; under a mesh the
    cache is the rank's block over ``model``, gathered for the step."""
    p = _weights(p, cfg)
    B, W = x.shape[0], _width(cfg)
    full = {"h": (B, W), "conv": (B, cfg.rglru.conv_width - 1, W)}
    whole = {k: rules.cache_whole(cache[k], k, full[k]) for k in full}
    y = x @ p["in_proj_y"]
    gate = _gelu(x @ p["in_proj_gate"])
    y, conv_state = _causal_conv(y, p["conv_w"], p["conv_b"], whole["conv"])
    a, b = _gates(p, y, cfg)  # (B,1,W)
    h = a[:, 0] * whole["h"] + b[:, 0]
    new = rules.cache_local({"h": h, "conv": conv_state})
    cache["h"].copy_(new["h"])
    cache["conv"].copy_(new["conv"])
    out = h[:, None].to(x.dtype) * gate
    return out @ p["out_proj"], cache
