"""Mamba-2 block via the SSD (state-space duality) chunked algorithm — the
counterpart of ``repro.models.layers.ssd``.

Per Dao & Gu (2024): the sequence is split into chunks of Q tokens; within
a chunk the SSM is computed in its quadratic "attention-like" dual form,
and a short sequential loop carries the (H, hd, N) states between chunks.
Decode keeps O(1) state, the cache ``{state (B,H,hd,N) f32, conv
(B,cw-1,conv_dim)}``, which it updates in place.

Layout: d_inner = expand * d_model, H = d_inner / head_dim heads, the B/C
projections have n_groups groups (broadcast over H/G heads each).  Where
the reference's einsums ask for ``preferred_element_type=float32`` on
bf16 operands, the operands are cast to float32 (a bf16 torch product
returns bf16).  The intra-chunk decay ``exp(cum_i - cum_j)`` is masked
before the ``exp`` (the reference masks after it, where the entries above
the diagonal may already have overflowed; the kept entries are the same).
``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it
(``F.softplus`` returns ``x`` itself above 20).

Under a mesh every rank of a model group computes the whole mixer: the
rules cut ``in_proj_*`` (fsdp, tp) and ``out_proj`` (tp, fsdp), and each
is gathered whole at its use (``rules.weight``; over ``model`` the
gradient's block is kept, over ``data`` it is reduce-scattered).  The
reference constrains nothing inside the mixer either.  A decode cache is
the rank's block over ``model`` (``rules.cache_pspecs``: the state's heads
and the conv's channels), gathered for the step and cut back after it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.common import causal_conv as _causal_conv
from repro_torch.models.layers.common import dense_init, draw_generator, torch_dtype
from repro_torch.sharding import rules


def dims(cfg: ArchConfig):
    """-> (d_inner, H, G, N, head_dim)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.n_groups, s.d_state, s.head_dim


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(n, generator=draw_generator(gen), dtype=torch.float32, device=gen.device) * (hi - lo) + lo


def init_ssd(gen: torch.Generator, cfg: ArchConfig) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, G, N, hd = dims(cfg)
    conv_dim = d_inner + 2 * G * N
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    dt_init = torch.exp(_uniform(gen, H, 0.0, 1.0) * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    return {
        "in_proj_z": dense_init(gen, (D, d_inner), dt),
        "in_proj_x": dense_init(gen, (D, d_inner), dt),
        "in_proj_bc": dense_init(gen, (D, 2 * G * N), dt),
        "in_proj_dt": dense_init(gen, (D, H), dt),
        "conv_w": dense_init(gen, (s.conv_width, conv_dim), dt, scale=1.0 / math.sqrt(s.conv_width)),
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=dev),
        "A_log": torch.log(_uniform(gen, H, 1.0, 16.0)),
        "D_skip": torch.ones(H, dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "norm_scale": torch.ones(d_inner, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _weights(p, cfg: ArchConfig) -> dict:
    """``p`` with the projections whole on this rank (see above)."""
    d_inner, H, G, N, _ = dims(cfg)
    D = cfg.d_model
    shapes = {"in_proj_z": (D, d_inner), "in_proj_x": (D, d_inner), "in_proj_bc": (D, 2 * G * N),
              "in_proj_dt": (D, H), "out_proj": (d_inner, D)}
    return {**p, **{n: rules.weight(p, n, shape) for n, shape in shapes.items()}}


def _project(p, x: torch.Tensor, cfg: ArchConfig, conv_state=None):
    """x (B,S,D) -> z (B,S,d_inner), xs (B,S,H,hd), Bm/Cm (B,S,G,N), dt
    (B,S,H) f32, and the conv state."""
    d_inner, H, G, N, hd = dims(cfg)
    z = x @ p["in_proj_z"]
    xi = x @ p["in_proj_x"]
    bc = x @ p["in_proj_bc"]
    dt_raw = x @ p["in_proj_dt"]
    xbc = torch.cat([xi, bc], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    B_, S = x.shape[:2]
    xs = xbc[..., :d_inner].reshape(B_, S, H, hd)
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(B_, S, G, N)
    Cm = xbc[..., d_inner + G * N:].reshape(B_, S, G, N)
    v = dt_raw.float() + p["dt_bias"]
    dtv = torch.logaddexp(v, torch.zeros_like(v))  # softplus, as jax.nn.softplus
    return z, xs, Bm, Cm, dtv, conv_state


def _finish(p, y: torch.Tensor, z: torch.Tensor, x_dtype, cfg: ArchConfig) -> torch.Tensor:
    """Gated RMSNorm + out-proj. y (B,S,H,hd) f32; z (B,S,d_inner)."""
    d_inner = z.shape[-1]
    B, S = y.shape[:2]
    yf = y.reshape(B, S, d_inner) * F.silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"]
    return yf.to(x_dtype) @ p["out_proj"]


def ssd_scan(p, x: torch.Tensor, cfg: ArchConfig, state=None, conv_state=None):
    """Full-sequence chunked SSD. x (B,S,D) -> (out, {state (B,H,hd,N) f32,
    conv}); ``state`` and ``conv_state`` carry a previous segment's."""
    d_inner, H, G, N, hd = dims(cfg)
    Q = min(cfg.ssm.chunk, x.shape[1])
    B_, S, _ = x.shape
    assert S % Q == 0, (S, Q)
    nc = S // Q
    Hg = H // G
    p = _weights(p, cfg)

    z, xs, Bm, Cm, dtv, conv_state = _project(p, x, cfg, conv_state)
    A = -torch.exp(p["A_log"])  # (H,)
    dA = dtv * A  # (B,S,H)

    # chunk everything: (B, nc, Q, ...)
    xs_c = xs.reshape(B_, nc, Q, G, Hg, hd)
    B_c = Bm.reshape(B_, nc, Q, G, N)
    C_c = Cm.reshape(B_, nc, Q, G, N)
    dt_c = dtv.reshape(B_, nc, Q, G, Hg)
    cum = torch.cumsum(dA.reshape(B_, nc, Q, G, Hg), dim=2)  # (B,nc,Q,G,Hg)

    # ---- intra-chunk (quadratic dual form) ----
    # L[i,j] = exp(cum_i - cum_j) for i >= j, 0 above the diagonal
    diff = cum[:, :, :, None] - cum[:, :, None, :]  # (B,nc,Qi,Qj,G,Hg)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()[None, None, :, :, None, None]
    L = torch.exp(torch.where(mask, diff, -math.inf))
    cb = torch.einsum("bcign,bcjgn->bcijg", C_c.float(), B_c.float())
    w = cb[..., None] * L * dt_c[:, :, None]  # (B,nc,Qi,Qj,G,Hg)
    y_intra = torch.einsum("bcijgh,bcjghp->bcighp", w.to(xs_c.dtype), xs_c)

    # ---- chunk-local states ----
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)  # (B,nc,Q,G,Hg)
    sl = torch.einsum(
        "bcqgn,bcqgh,bcqghp->bcghpn",
        B_c.float(), (decay_to_end * dt_c).to(B_c.dtype).float(), xs_c.float(),
    )  # (B,nc,G,Hg,hd,N)
    chunk_decay = torch.exp(cum[:, :, -1])  # (B,nc,G,Hg)

    # ---- inter-chunk state loop ----
    s = x.new_zeros((B_, G, Hg, hd, N), dtype=torch.float32) if state is None else (
        state.float().reshape(B_, G, Hg, hd, N))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = sl[:, c] + chunk_decay[:, c, ..., None, None] * s
    s_prevs = torch.stack(s_prevs, dim=1)  # (B,nc,G,Hg,hd,N)

    y_inter = torch.einsum(
        "bcqgn,bcqgh,bcghpn->bcqghp",
        C_c.float(), torch.exp(cum).to(C_c.dtype).float(), s_prevs.to(C_c.dtype).float(),
    )
    y = (y_intra.float() + y_inter).reshape(B_, S, H, hd)
    y = y + p["D_skip"][None, None, :, None] * xs.float()
    out = _finish(p, y, z, x.dtype, cfg)
    return out, {"state": s.reshape(B_, H, hd, N), "conv": conv_state}


def ssd_decode(p, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-step decode. x (B,1,D); cache {state (B,H,hd,N) f32, conv}.
    -> (out (B,1,D), cache), the cache updated in place."""
    d_inner, H, G, N, hd = dims(cfg)
    Bsz = x.shape[0]
    Hg = H // G
    p = _weights(p, cfg)
    full = {"state": (Bsz, H, hd, N), "conv": (Bsz, cfg.ssm.conv_width - 1, d_inner + 2 * G * N)}
    whole = {k: rules.cache_whole(cache[k], k, full[k]) for k in full}
    z, xs, Bm, Cm, dtv, conv_state = _project(p, x, cfg, whole["conv"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp((dtv * A)[:, 0])  # (B,H)
    state = whole["state"].reshape(Bsz, G, Hg, hd, N)
    bx = torch.einsum(
        "bgn,bgh,bghp->bghpn",
        Bm[:, 0].float(), dtv[:, 0].reshape(Bsz, G, Hg), xs[:, 0].reshape(Bsz, G, Hg, hd).float(),
    )
    state = dA.reshape(Bsz, G, Hg)[..., None, None] * state + bx
    y = torch.einsum("bgn,bghpn->bghp", Cm[:, 0].float(), state)
    y = y.reshape(Bsz, 1, H, hd) + p["D_skip"][None, None, :, None] * xs.float()
    new = rules.cache_local({"state": state.reshape(Bsz, H, hd, N), "conv": conv_state})
    cache["state"].copy_(new["state"])
    cache["conv"].copy_(new["conv"])
    return _finish(p, y, z, x.dtype, cfg), cache
