"""Optimizers over trees of tensors, AdamW and Adafactor, and the
warmup-cosine schedule — the counterparts of ``repro.training.optimizer``
on one device.

Each update works leaf by leaf and **in place**: ``update`` writes the new
moments, master weights and parameters into the tensors it is given and
returns the same trees (the reference returns new ones).  AdamW updates
each leaf through ``repro_torch.kernels.train.adamw_update``: one kernel
launch a leaf on the card, and on the CPU its plain version, which walks
the leaf in flat slices of at most ``SLICE`` elements, so its float32
temporaries never exceed a few slices however large a leaf is (a
full-width MoE layer's experts are one leaf of 0.8 G elements); the update
is elementwise, so slicing changes no number.  AdamW also takes the
global-norm clip's scale (``grad_scale``) and applies it to each gradient
inside the same pass, rounding as the clip's own pass rounds.  Adafactor's
factored moments and its update clip are per stacked leaf, as the
reference's are, so it takes each leaf whole.

Scalars (the learning rate, the bias corrections) are float32 0-dim
tensors on the parameters' device, computed as the reference's ``jnp``
float32 arithmetic does, and every division by one divides by a tensor
(torch turns a division by a Python scalar into a multiplication by its
reciprocal, which rounds twice).

Under a mesh, ``zero1_pspecs`` gives the specs of the optimizer state
(ZeRO-1) and ``Zero1`` applies them: each rank keeps only its block of
``m``, ``v``, ``master`` and Adafactor's ``f``, and the meshed train step
(``repro_torch.training.train_step``) hands ``update`` the blocks of the
gradients and parameters in that layout, with ``cuts``, the axis that cuts
each dim of each leaf's block.  AdamW is elementwise and needs no cut;
Adafactor's row and column means, its row-mean and the update's RMS are
sums over the block all-reduced over the axes that cut the dims they
reduce.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels import train as T
from repro_torch.kernels.train import flat_slices
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, current_mesh, layout
from repro_torch.tree import leaves, tree_map, unflatten


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-dim tensor on ``like``'s device, filled
    there (no copy from the host, which would wait for the device)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def warmup_cosine(base_lr: float, warmup: int, total: int, final_frac: float = 0.1):
    """-> ``lr(step)``: a float32 0-dim tensor on the step's device (a
    Python int step gives one on the CPU); linear warmup from 0, then a
    cosine to ``final_frac * base_lr`` at ``total``."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        c = lambda v: _f32(v, step)  # noqa: E731
        warm = c(base_lr) * step / c(max(warmup, 1))
        prog = ((step - c(warmup)) / c(max(total - warmup, 1))).clamp(0.0, 1.0)
        cos = c(final_frac) + c((1 - final_frac) * 0.5) * (c(1.0) + torch.cos(c(math.pi) * prog))
        return torch.where(step < c(warmup), warm, c(base_lr) * cos)

    return lr


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdamW:
    lr_fn: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master_weights: bool = True

    def init(self, params):
        """{"m", "v"} float32 zeros like ``params`` and, with master
        weights, {"master"}: a float32 copy of them."""
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        st = {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}
        if self.master_weights:
            st["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        return st

    def update(self, grads, state, params, step, cuts=None, grad_scale=None):
        """One step, in place: -> (params, state).  Elementwise, so the
        blocks of a ZeRO-1 layout update as they are (``cuts`` unused).
        ``grad_scale`` (a float32 0-dim tensor on the parameters' device,
        the clip's ``min(1, max_norm / norm)``) scales every gradient first,
        each rounded to its own dtype as the clip's pass would write it;
        the gradients themselves are left as they are."""
        flat_p = leaves(params)
        lr = self.lr_fn(step).to(flat_p[0].device)
        t = torch.as_tensor(step, device=lr.device).to(torch.float32) + 1.0
        c1 = _f32(1.0, lr) - _f32(self.b1, lr) ** t
        c2 = _f32(1.0, lr) - _f32(self.b2, lr) ** t
        lr_wd = lr * _f32(self.weight_decay, lr)
        refs = leaves(state["master"]) if self.master_weights else [None] * len(flat_p)
        with torch.no_grad():
            for g, m, v, ref, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]),
                                       refs, flat_p):
                T.adamw_update(g.contiguous(), m, v, ref, p, lr, c1, c2, lr_wd, grad_scale,
                               b1=self.b1, b2=self.b2, eps=self.eps)
        return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; memory ~ O(rows + cols))
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Adafactor:
    lr_fn: Callable
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _factored(self, shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(self, params):
        """{"f": one state dict per leaf, in flatten order}: {"vr", "vc"}
        for a factored leaf, {"v"} otherwise (float32 zeros)."""
        def leaf(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
            if self._factored(p.shape):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"f": [leaf(p) for p in leaves(params)]}

    def update(self, grads, state, params, step, cuts=None):
        """One step, in place: -> (params, state).  ``cuts`` (ZeRO-1
        blocks): per leaf, the mesh axis cutting each dim of its block, or
        ``None`` for whole leaves."""
        flat_p = leaves(params)
        lr = self.lr_fn(step).to(flat_p[0].device)
        c = lambda v: _f32(v, lr)  # noqa: E731
        t = torch.as_tensor(step, device=lr.device).to(torch.float32) + 1.0
        beta = c(1.0) - t ** c(-self.decay)
        keep = c(1.0) - beta
        cuts = cuts or [None] * len(flat_p)
        with torch.no_grad():
            for g, st, p, cut in zip(leaves(grads), state["f"], flat_p, cuts):
                g = g.float()
                g2 = g.square().add_(self.eps)
                if "vr" in st:
                    vr, vc = st["vr"], st["vc"]
                    vr.mul_(beta).add_(_mean(g2, -1, cut).mul_(keep))
                    vc.mul_(beta).add_(_mean(g2, -2, cut).mul_(keep))
                    rcut = None if cut is None else cut[:-1]
                    row_mean = _mean(vr, -1, rcut, keepdim=True)[..., None].clamp(min=self.eps)
                    denom = (vr[..., None] * vc[..., None, :] / row_mean).sqrt_()
                    u = g / denom.clamp_(min=self.eps)
                else:
                    st["v"].mul_(beta).add_(g2.mul_(keep))
                    u = g / st["v"].sqrt()
                rms = (_mean_all(u.square(), cut) + c(self.eps)).sqrt()
                u.div_((rms / c(self.clip_threshold)).clamp(min=1.0))
                pf = p.float()
                decay = lr * c(self.weight_decay) * pf
                p.copy_(pf.sub_(u.mul_(lr)).sub_(decay))
        return params, state


def _mean(x: torch.Tensor, dim: int, cut, keepdim: bool = False) -> torch.Tensor:
    """The mean of a leaf along ``dim`` from this rank's block ``x``: the
    block's sum all-reduced over the axis that cuts ``dim`` (``cut[dim]``),
    over the whole dim's size; ``x.mean(dim)`` where nothing cuts it."""
    axis = None if cut is None else cut[dim]
    if axis is None:
        return x.mean(dim, keepdim=keepdim)
    n = x.shape[dim] * rules.axis_size(axis)
    return rules.all_reduce(x.sum(dim, keepdim=keepdim), axis) / _f32(n, x)


def _mean_all(x: torch.Tensor, cut) -> torch.Tensor:
    """The mean of a whole leaf from this rank's block ``x`` (the block's
    sum all-reduced over every axis that cuts it)."""
    axes = [] if cut is None else [a for a in cut if a is not None]
    if not axes:
        return x.mean()
    total = x.sum()
    n = x.numel()
    for a in axes:
        total = rules.all_reduce(total, a)
        n *= rules.axis_size(a)
    return total / _f32(n, x)


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100, total: int = 10000, **kw):
    sched = warmup_cosine(lr, warmup, total)
    if name == "adamw":
        return AdamW(sched, **kw)
    if name == "adafactor":
        return Adafactor(sched, **kw)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# ZeRO-1 state sharding
# ---------------------------------------------------------------------------


def _spec_leaves(tree) -> list:
    """A spec tree's ``P`` leaves in flatten order (a ``P`` is a tuple, so
    the tree helpers would walk into it)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _spec_leaves(v)]
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def _widen(spec, shape, data: int) -> P:
    """A leaf's spec with the first unsharded dim that ``data`` divides
    (and is at least ``data`` long) put on the data axis, unless the spec
    already uses it (ZeRO-1)."""
    used = {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}
    new = list(spec) + [None] * (len(shape) - len(spec))
    if "data" not in used:
        for i, (dim, s) in enumerate(zip(shape, new)):
            if s is None and dim >= data and dim % data == 0:
                new[i] = "data"
                break
    return P(*new)


def zero1_pspecs(params, param_pspecs, opt_state):
    """Spec tree for ``opt_state``: the params' specs with the first
    unsharded, large-enough dim additionally put on the data axis (ZeRO-1).
    AdamW's ``m``/``v``/``master`` mirror the params; Adafactor's ``f``
    list gives each factored leaf ``{"vr", "vc"}`` (the spec without its
    last dim, and without its second-to-last) and every other leaf
    ``{"v"}``; any other entry is replicated."""
    mesh = current_mesh()
    data = layout(mesh).shape.get("data", 1) if mesh is not None else 1
    flat_p = leaves(params)
    flat_spec = _spec_leaves(param_pspecs)
    wide = [_widen(s, p.shape, data) for s, p in zip(flat_spec, flat_p)]
    out = {}
    for k, v in opt_state.items():
        if k in ("m", "v", "master"):
            out[k] = unflatten(params, wide)
        elif k == "f":
            fl = []
            for spec, leaf in zip(wide, flat_p):
                ax = list(spec) + [None] * (leaf.ndim - len(spec))
                if leaf.ndim >= 2 and leaf.shape[-1] > 1 and leaf.shape[-2] > 1:
                    fl.append({"vr": P(*ax[:-1]), "vc": P(*(ax[:-2] + ax[-1:]))})
                else:
                    fl.append({"v": P(*ax)})
            out[k] = fl
        else:
            out[k] = tree_map(lambda _: P(), v)
    return out


class Zero1:
    """ZeRO-1 applied, under the active mesh (with none, the identity:
    every block is the whole leaf, nothing is summed, cut or gathered, and
    the global norm is the plain one).  Built from the full
    parameters' shapes (any tree of leaves with ``shape``/``ndim``, e.g.
    ``init_train_params(MetaGenerator(), cfg)``); per leaf in flatten
    order it keeps the parameter's spec (``params_pspecs``), its
    optimizer state's (``zero1_pspecs``' widening) and the dim the
    widening put on ``data`` (``None`` where the parameter is already cut
    on ``data``, no dim is long enough — that leaf's update then runs on
    every data rank, on the same summed gradient — or the data axis has
    one rank, where every block is the parameter itself and nothing is
    copied).

    * ``grad_block``: a rank's gradient of its parameter block (its data
      shard's share where the leaf is replicated over a data axis) -> the
      summed gradient's block in the optimizer's layout (reduce-scattered
      over ``data`` on the widened dim, all-reduced over every other data
      axis the leaf is replicated on);
    * ``param_block``: the parameter block -> its block in that layout (a
      copy); ``put_back`` all-gathers an updated block over ``data`` into
      the parameter block;
    * ``global_norm``: the gradients' global norm from their blocks, each
      leaf's squares summed once: over its block, all-reduced over the
      axes that cut it (replicated copies are not counted again);
    * ``cuts``: each leaf's optimizer spec, for ``Adafactor.update``;
      ``axes(i)`` the mesh axes that cut leaf ``i``'s block and
      ``block_shape(i)`` the block's shape (gradient compression reduces
      over those axes and keeps its residual in those blocks)."""

    def __init__(self, full_params):
        mesh = current_mesh()
        flat = leaves(full_params)
        self.shapes = [tuple(p.shape) for p in flat]
        if mesh is None:  # the identity: every block the whole leaf
            self.dp, self.specs = (), [(None,) * len(shape) for shape in self.shapes]
            self.cuts, self.dims = self.specs, [None] * len(flat)
            return
        names = layout(mesh).axis_names
        self.dp = tuple(a for a in ("pod", "data") if a in names)
        data = layout(mesh).shape.get("data", 1)
        self.specs = [tuple(s) + (None,) * (len(shape) - len(s))
                      for s, shape in zip(_spec_leaves(rules.params_pspecs(full_params)), self.shapes)]
        self.cuts = [tuple(_widen(s, shape, data)) for s, shape in zip(self.specs, self.shapes)]
        self.dims = [next((i for i, (a, b) in enumerate(zip(s, w)) if a != b), None)
                     if data > 1 else None for s, w in zip(self.specs, self.cuts)]

    def grad_block(self, i: int, g: torch.Tensor) -> torch.Tensor:
        spec, dim = self.specs[i], self.dims[i]
        for axis in self.dp:
            if axis in spec:
                continue
            if axis == "data" and dim is not None:
                g = rules.reduce_scatter(g, "data", dim)
            else:
                g = rules.all_reduce(g.contiguous().clone(), axis)
        return g

    def param_block(self, i: int, p: torch.Tensor) -> torch.Tensor:
        dim = self.dims[i]
        if dim is None:
            return p
        n = p.shape[dim] // rules.axis_size("data")
        return p.narrow(dim, rules.axis_index("data") * n, n).contiguous()

    def put_back(self, i: int, p: torch.Tensor, block: torch.Tensor) -> None:
        dim = self.dims[i]
        if dim is not None:
            p.copy_(rules.all_gather(block, "data", dim))
        elif block is not p:
            p.copy_(block)

    def axes(self, i: int) -> tuple:
        return tuple(sorted({a for a in self.cuts[i] if a is not None}))

    def block_shape(self, i: int) -> tuple:
        return tuple(n if a is None else n // rules.axis_size(a)
                     for n, a in zip(self.shapes[i], self.cuts[i]))

    def global_norm(self, blocks) -> torch.Tensor:
        groups: dict = {}
        for i, g in enumerate(blocks):
            key = self.axes(i)
            sq = sum(s.float().square().sum() for (s,) in flat_slices(g.contiguous()))
            groups[key] = groups.get(key, 0) + sq
        total = torch.zeros((), dtype=torch.float32, device=blocks[0].device)
        for key in sorted(groups):
            s = groups[key] if torch.is_tensor(groups[key]) else total.new_tensor(groups[key])
            for axis in key:
                s = rules.all_reduce(s.clone(), axis)
            total = total + s
        return total.sqrt()
