"""Gradient compression with error feedback — the counterpart of
``repro.training.compression``.

* ``int8`` — per-tensor symmetric int8 quantise -> dequantise, the residual
  carried in float32 to the next step;
* ``topk`` — keep the entries whose magnitude reaches the k-th largest
  (``k = max(1, int(numel * frac))``, ties at the threshold kept), the
  rest carried;
* ``none`` — identity.

The reference applies the hook to the gradient tree inside its train step,
as a simulation of compressing the cross-pod all-reduce; so does this one.
``torch.round`` rounds half to even, as ``jnp.round`` does.  Each
compression is per leaf, so it sees the train state's stacked leaves.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """-> (dequantised gradient in g's dtype, new residual)."""
    gf = g.float() + err
    scale = gf.abs().max().clamp(min=1e-12) / torch.tensor(127.0, device=gf.device)
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def compress_topk(g: torch.Tensor, err: torch.Tensor, frac: float = 0.05):
    """-> (the entries at or above the k-th largest magnitude, zeros
    elsewhere, in g's dtype; new residual)."""
    gf = g.float() + err
    k = max(1, int(gf.numel() * frac))
    thresh = torch.topk(gf.abs().reshape(-1), k).values[-1]
    kept = torch.where(gf.abs() >= thresh, gf, torch.zeros((), device=gf.device))
    return kept.to(g.dtype), gf - kept


def apply_compression(grads, err_state, kind: str, **kw):
    """-> (compressed grads, new error state)."""
    if kind == "none":
        return grads, err_state
    fn = {"int8": compress_int8, "topk": compress_topk}[kind]
    pairs = [fn(g, e, **kw) for g, e in zip(leaves(grads), leaves(err_state))]
    return unflatten(grads, [p[0] for p in pairs]), unflatten(err_state, [p[1] for p in pairs])
