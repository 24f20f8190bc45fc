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

Under a mesh the train step hands each hook a leaf's ZeRO-1 block of the
summed gradient (``optimizer.Zero1``), with the leaf's full element count
and the mesh axes that cut it, and the hook computes what the reference
computes on the whole leaf: ``int8``'s scale from the block's largest
magnitude all-reduced (MAX) over those axes, ``topk``'s threshold from
``kth_magnitude``, an exact radix select whose histograms are all-reduced
(SUM) over them.  A copy replicated over an axis that does not cut the
leaf is counted once, as ``Zero1.global_norm`` counts it.  With no mesh
the axes are empty, nothing is reduced and the block is the leaf.  On the
card the select is the radix select's kernels
(``repro_torch.kernels.train.radix_select``), with or without a mesh; on
the CPU an unmeshed threshold is ``torch.topk``'s k-th value, the same
value bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import train as T
from repro_torch.sharding import rules
from repro_torch.tree import leaves, unflatten


def init_error_state(params):
    """The error-feedback residual of a tree: float32 zeros of each leaf's
    shape, on the leaf's device (``repro.training.compression``'s
    ``init_error_state``)."""
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                              for p in leaves(params)])


def _all_reduce(x: torch.Tensor, axes, op: str) -> torch.Tensor:
    for axis in axes:
        x = rules.all_reduce(x, axis) if op == "sum" else rules.all_reduce_max(x, axis)
    return x


def kth_magnitude(gf: torch.Tensor, k: int, axes=()) -> torch.Tensor:
    """The k-th largest ``|x|``, counted with multiplicity, over the leaf
    whose block on this rank is ``gf`` (float32) and whose other blocks lie
    on the ranks of the mesh ``axes`` (every rank of them calls this with
    the same ``k``): a float32 0-dim tensor, equal bit for bit to
    ``torch.topk(|leaf|, k).values[-1]``.  On the card, and under a mesh,
    ``radix_kth_magnitude``; on the CPU with no axes (the block is the
    leaf) that ``torch.topk`` call."""
    if not 1 <= k:
        raise ValueError(f"k must be >= 1, got {k}")
    if not axes and gf.device.type != "cuda":
        return torch.topk(gf.abs().reshape(-1), k).values[-1]
    return radix_kth_magnitude(gf, k, axes)


def radix_kth_magnitude(gf: torch.Tensor, k: int, axes=()) -> torch.Tensor:
    """``kth_magnitude`` by the exact radix select
    (``repro_torch.kernels.train.radix_select``: three rounds over
    ``|gf|.view(int32)``, each a histogram of one digit of the patterns
    that match the digits found so far and the choice of the digit at
    which the count from the top reaches the rank still sought), each
    round's histogram summed over ``axes`` between its two launches; the
    whole select leaves nothing to the host."""
    return T.radix_select(gf, k, lambda hist: _all_reduce(hist, axes, "sum"))


def compress_int8(g: torch.Tensor, err: torch.Tensor, axes=()):
    """-> (dequantised gradient in g's dtype, new residual); the scale
    from the largest magnitude of the leaf whose block is ``g``."""
    gf = g.float() + err
    top = _all_reduce(gf.abs().max(), axes, "max")
    scale = top.clamp(min=1e-12) / torch.full((), 127.0, device=gf.device)
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def compress_topk(g: torch.Tensor, err: torch.Tensor, frac: float = 0.05, numel: int | None = None,
                  axes=()):
    """-> (the entries at or above the k-th largest magnitude of the leaf
    whose block is ``g``, zeros elsewhere, in g's dtype; new residual).
    ``k`` counts the whole leaf's ``numel`` elements (the block's when not
    given)."""
    gf = g.float() + err
    k = max(1, int((gf.numel() if numel is None else numel) * frac))
    thresh = kth_magnitude(gf, k, axes)
    kept = torch.where(gf.abs() >= thresh, gf, torch.zeros((), device=gf.device))
    return kept.to(g.dtype), gf - kept


def compress(kind: str, g: torch.Tensor, err: torch.Tensor, numel: int, axes=()):
    """One leaf's block ``g`` of the summed gradient and its residual
    block -> (compressed block, new residual block); ``numel`` is the
    whole leaf's element count and ``axes`` the mesh axes that cut it."""
    if kind == "int8":
        return compress_int8(g, err, axes)
    if kind == "topk":
        return compress_topk(g, err, numel=numel, axes=axes)
    raise KeyError(kind)


def apply_compression(grads, err_state, kind: str):
    """-> (compressed grads, new error state), every leaf whole."""
    if kind == "none":
        return grads, err_state
    pairs = [compress(kind, g, e, g.numel()) for g, e in zip(leaves(grads), leaves(err_state))]
    return unflatten(grads, [p[0] for p in pairs]), unflatten(err_state, [p[1] for p in pairs])
