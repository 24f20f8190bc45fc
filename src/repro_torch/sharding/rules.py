"""Logical-axis sharding rules and the mesh context — the counterpart of
``repro.sharding.rules``.

Model code names *logical* axes; this module resolves them against the
active mesh (single-pod ``(data, model)`` or multi-pod ``(pod, data,
model)``).  With no mesh active every spec is empty and every annotation
is a no-op, so the same model code runs on one device.

Logical axes:
    dp      batch                          -> (pod, data) / (data,)
    tp      heads / ff / experts / vocab   -> model
    fsdp    weight embed-dim ZeRO-3        -> data (only with fsdp on)
    sp      sequence (long-context)        -> data

A spec is a ``P``: a tuple whose entries are ``None``, a mesh axis name or
a tuple of names (major to minor), one entry per tensor dim, as the JAX
package's ``PartitionSpec`` holds them.  The active mesh is a
``torch.distributed`` ``DeviceMesh`` or a rank-less
``repro_torch.launch.mesh.MeshLayout`` (the rules need only its axis names
and sizes).  ``placements`` turns a spec into DTensor placements and
``local_slice`` cuts the rank's block of a full tensor, as a ``shard_map``
in-spec hands each device its block.

There is no ``shard_map`` here: the mesh bodies of the port
(``repro_torch.kernels.ops.make_sharded_route``,
``repro_torch.models.layers.moe.apply_moe``) are per-rank code with
explicit collectives over ``mesh.get_group(axis)``.
"""
from __future__ import annotations

import re
from contextlib import contextmanager

import torch

from repro_torch.launch.mesh import MeshLayout, layout

_ACTIVE: dict = {"mesh": None, "fsdp": False, "expert_layout": "ep"}


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``.
    A one-name tuple entry is stored as the name."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                if len(e) == 1:
                    e = e[0]
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def set_mesh(mesh, fsdp: bool = False, expert_layout: str = "ep") -> None:
    if expert_layout not in ("ep", "tp"):
        raise ValueError(f"expert_layout must be 'ep' or 'tp', got {expert_layout!r}")
    _ACTIVE["mesh"] = mesh
    _ACTIVE["fsdp"] = fsdp
    _ACTIVE["expert_layout"] = expert_layout


def current_mesh():
    return _ACTIVE["mesh"]


def fsdp() -> bool:
    """Whether the active mesh context puts the parameters' ``fsdp`` dims
    on the data axis."""
    return _ACTIVE["fsdp"]


def expert_layout() -> str:
    """"ep" (experts over model — train/prefill) or "tp" (per-expert tensor
    parallelism, experts replicated over model with their ff dim sharded —
    decode/serving, where one-token-per-expert capacities make EP useless)."""
    return _ACTIVE["expert_layout"]


@contextmanager
def mesh_context(mesh, fsdp: bool = False, expert_layout: str = "ep"):
    prev = (_ACTIVE["mesh"], _ACTIVE["fsdp"], _ACTIVE["expert_layout"])
    set_mesh(mesh, fsdp, expert_layout)
    try:
        yield
    finally:
        set_mesh(*prev)


def _resolve(axis: str | None, mesh) -> tuple | str | None:
    names = layout(mesh).axis_names
    if axis is None:
        return None
    if axis == "dp":
        return ("pod", "data") if "pod" in names else ("data",)
    if axis == "tp":
        return "model"
    if axis == "sp":
        return "data"
    if axis == "fsdp":
        return "data" if _ACTIVE["fsdp"] else None
    raise ValueError(f"unknown logical axis {axis!r}")


def logical(*axes: str | None) -> P:
    """Resolve logical axis names to a spec for the active mesh."""
    mesh = current_mesh()
    if mesh is None:
        return P()
    return P(*[_resolve(a, mesh) for a in axes])


def fitted(shape, *axes: str | None) -> P:
    """``logical`` plus the divisibility guard against a concrete shape."""
    mesh = current_mesh()
    if mesh is None:
        return P()
    return fit_spec([_resolve(a, mesh) for a in axes], shape, mesh)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(entry, mesh) -> int:
    sizes = layout(mesh).shape
    n = 1
    for name in _names(entry):
        n *= sizes[name]
    return n


def fit_spec(resolved_axes, shape, mesh) -> P:
    """Drop mesh axes from dims they don't evenly divide."""
    out = []
    for dim, entry in zip(shape, resolved_axes):
        if entry is not None and dim % _axis_size(entry, mesh) != 0:
            entry = None
        out.append(entry)
    return P(*out)


# ---------------------------------------------------------------------------
# DTensor placements, local blocks, and the layout constraint
# ---------------------------------------------------------------------------


def placements(spec, mesh) -> list:
    """A spec -> one DTensor placement per mesh dim: ``Shard(i)`` on each
    mesh dim that tensor dim ``i``'s entry names (a tuple entry shards on
    all of its axes, major to minor, as JAX lays it out), ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = layout(mesh).axis_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not major to minor on the mesh {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def coordinate(mesh) -> dict:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    names = layout(mesh).axis_names
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(names, coord))


def block(entry, mesh, coord: dict) -> tuple[int, int]:
    """-> ``(index, count)`` of the block of a dim sharded by ``entry``
    that the rank at ``coord`` holds (major to minor over the entry's
    axes)."""
    sizes = layout(mesh).shape
    index, count = 0, 1
    for name in _names(entry):
        index = index * sizes[name] + coord[name]
        count *= sizes[name]
    return index, count


def local_slice(x, spec, mesh, coord: dict | None = None):
    """The block of the full array or tensor ``x`` that spec ``spec``
    gives the rank at ``coord`` (this rank's by default)."""
    coord = coordinate(mesh) if coord is None else coord
    index = []
    for dim, entry in enumerate(spec):
        i, n = block(entry, mesh, coord)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        size = x.shape[dim] // n
        index.append(slice(i * size, (i + 1) * size))
    return x[tuple(index)]


def _constrain(x, spec, mesh):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(spec, mesh))
    return x


def shard(x, *axes: str | None):
    """The layout constraint of the active mesh (no-op with none; axes that
    don't divide their dim are dropped).  A plain tensor is returned as it
    is — it is this rank's value, and the value does not change; a DTensor
    is redistributed to the spec's placements.  JAX's
    ``with_sharding_constraint`` is a hint to GSPMD's partitioner, which
    torch has no counterpart of: the port's mesh code places its tensors
    and collectives itself."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return _constrain(x, fit_spec([_resolve(a, mesh) for a in axes], x.shape, mesh), mesh)


# ---------------------------------------------------------------------------
# Parameter partition specs, by path-name rules.
#
# Conventions (all stacked params carry a leading layer dim -> None):
#   embedding (V, D)            vocab -> tp, D -> fsdp
#   unembed   (D, V)            D -> fsdp, vocab -> tp
#   wq/wk/wv  (.., D, H, hd)    D -> fsdp, H -> tp
#   wo        (.., H, hd, D)    H -> tp, D -> fsdp
#   mlp wi/wg (.., D, F)        D -> fsdp, F -> tp
#   mlp wo    (.., F, D)        F -> tp, D -> fsdp
#   experts   (.., E, D, F)     E -> tp (expert parallelism)
#   router    (.., D, E)        replicated
#   biases / norms / scalars    replicated
#   ssd/rglru small weights     replicated (elementwise channel params)
# ---------------------------------------------------------------------------

_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # order matters — first match wins. Specs are for the TRAILING dims
    # (leading scan/layer dims padded with None automatically).
    (r"embedding$", ("tp", "fsdp")),
    (r"unembed$", ("fsdp", "tp")),
    (r"(wq|wk|wv)$", ("fsdp", "tp")),  # fused (D, H*hd)
    (r"wo_attn$", ("tp", "fsdp")),  # fused (H*hd, D)
    (r"(w_dkv|w_dq)$", ("fsdp", None)),  # MLA down-proj (D, r)
    (r"(w_uq|w_uk|w_uv)$", (None, "tp", None)),  # MLA up-proj (r, H, hd)
    (r"w_qr$", (None, "tp", None)),  # MLA rope-q (r, H, hd_r)
    (r"w_kr$", ("fsdp", None)),  # MLA rope-k (D, hd_r)
    (r"(wi|wg)$", ("fsdp", "tp")),
    (r"wo_mlp$", ("tp", "fsdp")),
    (r"experts_(wi|wg)$", ("tp", "fsdp", None)),  # (E, D, Fe) — EP + ZeRO-3
    (r"experts_wo$", ("tp", None, "fsdp")),  # (E, Fe, D)
    (r"router$", (None, None)),
    (r"in_proj(_[a-z]+)?$", ("fsdp", "tp")),  # ssm / rglru in-projections
    (r"out_proj$", ("tp", "fsdp")),
    (r".*", ()),  # everything else fully replicated
]


def _trailing_spec(trailing, ndim: int, shape) -> P:
    t = list(trailing)
    if len(t) > ndim:
        t = t[-ndim:]
    axes = [None] * (ndim - len(t)) + t
    mesh = current_mesh()
    if mesh is None:
        return P()
    return fit_spec([_resolve(a, mesh) for a in axes], shape, mesh)


def _spec_for(path: str, leaf) -> P:
    ndim = getattr(leaf, "ndim", 0)
    shape = tuple(getattr(leaf, "shape", ()))
    if _ACTIVE["expert_layout"] == "tp" and re.search(r"experts_(wi|wg|wo)$", path):
        trailing = (None, "fsdp", "tp") if re.search(r"experts_(wi|wg)$", path) else (None, "tp", "fsdp")
        return _trailing_spec(trailing, ndim, shape)
    for pat, trailing in _RULES:
        if re.search(pat, path):
            return _trailing_spec(trailing, ndim, shape)
    return P()


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def param_spec(path: str, shape) -> P:
    """The spec ``params_pspecs`` gives a leaf at ``path`` of ``shape``."""
    return _spec_for(path, _Shape(shape))


def _walk(prefix: str, tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(f"{prefix}/{k}", v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(f"{prefix}/{i}", v, fn) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def params_pspecs(params):
    """The spec tree matching ``params`` (the active mesh).  Leaves are
    anything with ``ndim`` and ``shape`` (tensors, numpy arrays, shape
    records); dicts and lists are walked, a list item's path component
    being its index."""
    return _walk("", params, _spec_for)


def constrain_params(params):
    """Pin a parameter tree to its rule layouts: each DTensor leaf is
    redistributed to its spec's placements, plain tensors are returned as
    they are (see ``shard``)."""
    mesh = current_mesh()
    if mesh is None:
        return params
    return _walk("", params, lambda path, x: _constrain(x, _spec_for(path, x), mesh))


_CACHE_SPECS = {
    # KV-style caches shard the TIME dim on the model axis (flash-decoding
    # style): kv-head counts (1..8) rarely divide a 16-way axis, while the
    # cache length always does.
    "k": ("dp", "tp", None, None),
    "v": ("dp", "tp", None, None),
    "pos": ("dp", "tp"),
    "ckv": ("dp", "tp", None),
    "kr": ("dp", "tp", None),
    "h": ("dp", "tp"),
    "state": ("dp", "tp", None, None),
    "conv": ("dp", None, "tp"),
}


def cache_pspecs(cache_like):
    """Spec tree for a decode cache (leading stacked-layer dim)."""
    mesh = current_mesh()

    def walk(name, tree):
        if isinstance(tree, dict):
            return {k: walk(k, v) for k, v in tree.items()}
        if mesh is None or name == "cur":
            return P()
        trailing = _CACHE_SPECS.get(name, ())
        ndim = getattr(tree, "ndim", 0)
        axes = [None] * (ndim - len(trailing)) + [_resolve(a, mesh) for a in trailing]
        return fit_spec(axes, tuple(getattr(tree, "shape", ())), mesh)

    return walk("", cache_like)


def cache_cut(name: str, shape) -> int | None:
    """The dim of one layer's cache leaf ``name`` of full ``shape`` (no
    stacked layer dim) that ``cache_pspecs`` puts on the model axis of
    the active mesh, or ``None`` (no such axis of more than one rank, or
    it does not divide the dim)."""
    trailing = _CACHE_SPECS.get(name, ())
    tp = axis_size("model")
    if tp == 1 or "tp" not in trailing:
        return None
    d = len(shape) - len(trailing) + trailing.index("tp")
    return d if shape[d] % tp == 0 else None


def cache_local_shape(name: str, shape) -> tuple:
    """The shape of this rank's block of a cache leaf of full ``shape``."""
    shape = tuple(shape)
    d = cache_cut(name, shape)
    if d is None:
        return shape
    return shape[:d] + (shape[d] // axis_size("model"),) + shape[d + 1:]


def cache_local(cache: dict) -> dict:
    """One layer's full cache -> this rank's block of each leaf over the
    model axis (``cache_cut``)."""
    out = {}
    for k, v in cache.items():
        d = cache_cut(k, v.shape)
        if d is not None:
            n = v.shape[d] // axis_size("model")
            v = v.narrow(d, axis_index("model") * n, n).contiguous()
        out[k] = v
    return out


def cache_whole(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    """This rank's block of a cache leaf of full ``shape`` -> the whole
    leaf, gathered over the model axis where ``cache_cut`` cuts it."""
    d = cache_cut(name, shape)
    return t if d is None else all_gather(t, "model", d)


def batch_pspecs(batch_like):
    """Spec tree for an input batch: batch dim -> dp."""
    mesh = current_mesh()

    def leaf(name, tree):
        if mesh is None:
            return P()
        dp = _resolve("dp", mesh)
        ndim = getattr(tree, "ndim", 0)
        shape = tuple(getattr(tree, "shape", ()))
        if name == "positions":  # (3, B, S)
            axes = [None, dp] + [None] * (ndim - 2)
        else:
            axes = [dp] + [None] * (ndim - 1)
        return fit_spec(axes, shape, mesh)

    return {k: leaf(k, v) for k, v in batch_like.items()}


def params_shardings(params):
    """The DTensor placements of every parameter under the active mesh."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("no active mesh")
    return _walk("", params, lambda path, x: placements(_spec_for(path, x), mesh))


def params_local(params, mesh=None):
    """Each leaf of a full parameter tree cut to this rank's block of its
    spec (the active mesh unless ``mesh`` is given; a ``MeshLayout`` has
    no ranks to cut for)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or isinstance(mesh, MeshLayout):
        raise RuntimeError("params_local needs an active DeviceMesh")
    coord = coordinate(mesh)
    return _walk("", params, lambda path, x: local_slice(x, _spec_for(path, x), mesh, coord))


# ---------------------------------------------------------------------------
# Collectives over one mesh axis.
#
# ``all_gather``/``all_reduce``/``all_reduce_max`` have no gradient: they
# raise when autograd records and their input requires a gradient, so no
# collective is ever backpropagated through without a rule.  The
# differentiable ones follow one convention (Megatron's tensor parallelism
# with DDP over the data axes):
#
# * every rank holds the loss as the same value (the global mean) and
#   backpropagates 1 from it; a rank's graph holds only its own data
#   shard's work, so what reaches a tensor on a rank is its data shard's
#   share of the gradient;
# * the ranks of a ``model`` group compute a tensor replicated over
#   ``model`` alike, and each gets its whole gradient;
# * the gradient of a leaf replicated over the data axes is summed over
#   them after the backward (the train step does it).
#
# The pairs that follow from it:
#   copy_to(x, axis)         identity; all-reduce backward — a replicated
#                            tensor entering a region where each rank of
#                            ``axis`` computes a part
#   reduce_from(x, axis)     all-reduce; identity backward — the parts
#                            summed into a tensor replicated over ``axis``
#   gather(x, axis, dim)     all-gather; reduce-scatter (sum) backward —
#                            each rank of ``axis`` uses the whole in its
#                            own part (fsdp weights over data, weights
#                            re-laid over model, tokens over data)
#   gather(..., grad="block")  all-gather; the rank's block of the
#                            gradient — every rank of ``axis`` computes the
#                            same thing with the whole
# Over an axis of one rank each is the identity and copies nothing.
# ---------------------------------------------------------------------------


def axis_size(axis: str) -> int:
    """The size of mesh axis ``axis`` under the active mesh (1 with none
    or where the mesh has no such axis)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return layout(mesh).shape.get(axis, 1)


def axis_index(axis: str) -> int:
    """This rank's index on mesh axis ``axis`` (0 with no mesh)."""
    if axis_size(axis) == 1:
        return 0
    return coordinate(current_mesh())[axis]


def _group(axis: str):
    return current_mesh().get_group(axis)


def _refuse_grad(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{what} has no gradient rule and autograd is recording on an input that "
            "requires a gradient: use copy_to, reduce_from or gather")


def _gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    g = _group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The sum over ``axis``, cut along ``dim`` to this rank's block.  Gloo
    reduce-scatters CPU tensors only, so a gloo group (ranks sharing one
    card) all-reduces a CUDA tensor and keeps the rank's block: the same
    values, more traffic."""
    import torch.distributed as dist

    g = _group(axis)
    n = dist.get_world_size(g)
    if x.is_cuda and dist.get_backend(g) == "gloo":
        return _sum(x, axis).chunk(n, dim=dim)[dist.get_rank(g)].contiguous()
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=g)
    return out


def _sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous().clone()
    dist.all_reduce(x, group=_group(axis))
    return x


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over mesh axis
    ``axis`` (a tiled all-gather), in the axis's rank order.  No
    gradient."""
    if axis_size(axis) == 1:
        return x
    _refuse_grad(x, "all_gather")
    return _gather(x, axis, dim)


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum ``x`` over mesh axis ``axis`` (in place; returns ``x``).  No
    gradient."""
    import torch.distributed as dist

    if axis_size(axis) > 1:
        _refuse_grad(x, "all_reduce")
        dist.all_reduce(x, group=_group(axis))
    return x


def reduce_scatter(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` summed over mesh axis ``axis``, cut along ``dim``
    to this rank's block.  No gradient."""
    if axis_size(axis) == 1:
        return x
    _refuse_grad(x, "reduce_scatter")
    return _reduce_scatter(x, axis, dim % x.ndim)


def all_reduce_max(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The elementwise maximum of ``x`` over mesh axis ``axis`` (a new
    tensor).  No gradient."""
    import torch.distributed as dist

    if axis_size(axis) == 1:
        return x
    _refuse_grad(x, "all_reduce_max")
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(axis))
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, grad):
        ctx.axis, ctx.dim, ctx.grad, ctx.size = axis, dim, grad, x.shape[dim]
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return _reduce_scatter(g, ctx.axis, ctx.dim), None, None, None
        i = axis_index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(), None, None, None


def copy_to(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Identity forward, gradient summed over ``axis`` (see above)."""
    return x if axis_size(axis) == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis`` (a new tensor), identity backward."""
    return x if axis_size(axis) == 1 else _ReduceFrom.apply(x, axis)


def gather(x: torch.Tensor, axis: str, dim: int, grad: str = "sum") -> torch.Tensor:
    """Every rank's ``x`` over ``axis`` concatenated along ``dim``;
    backward ``grad="sum"`` reduce-scatters the gradient, ``"block"``
    takes the rank's block of it (see above)."""
    if grad not in ("sum", "block"):
        raise ValueError(f"grad must be 'sum' or 'block', got {grad!r}")
    dim = dim % x.ndim
    return x if axis_size(axis) == 1 else _Gather.apply(x, axis, dim, grad)


def dp_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data axes (``pod``, ``data``) of the active
    mesh, replicated over them (``reduce_from``: each shard's ``t`` gets
    the sum's gradient); ``t`` itself with none."""
    for axis in ("pod", "data"):
        t = reduce_from(t, axis)
    return t


def part(x: torch.Tensor, dim: int, axis: str | None) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor replicated over
    ``axis`` that the rank uses only in its part (a bias of a
    column-parallel product): ``copy_to`` then the block."""
    if axis is None or axis_size(axis) == 1:
        return x
    n = x.shape[dim] // axis_size(axis)
    return copy_to(x, axis).narrow(dim, axis_index(axis) * n, n)


def relayout(w: torch.Tensor, have, want, *, whole: bool = False) -> torch.Tensor:
    """This rank's block of a weight cut by spec ``have`` -> its block
    under spec ``want`` (entries ``None`` or one axis name; a shorter spec
    is padded with ``None``): a dim cut on an axis it should not be is
    gathered over that axis, then a dim that should be cut and is not is
    narrowed to the rank's block.  A gather over ``model`` takes
    ``grad="block"`` when ``whole`` (every rank of the model group
    computes the same thing with the weight), else ``"sum"``; a gather
    over a data axis always sums."""
    have = list(have) + [None] * (w.ndim - len(have))
    want = list(want) + [None] * (w.ndim - len(want))
    for dim, (h, t) in enumerate(zip(have, want)):
        if h is not None and h != t:
            w = gather(w, h, dim, "block" if whole and h == "model" else "sum")
    for dim, (h, t) in enumerate(zip(have, want)):
        if t is not None and h != t:
            size = w.shape[dim] // axis_size(t)
            w = w.narrow(dim, axis_index(t) * size, size)
    return w


def weight(p: dict, name: str, shape, want=(), *, use: str = "whole") -> torch.Tensor:
    """``p[name]``, this rank's block of a weight whose full shape is
    ``shape`` (cut by ``param_spec(name, shape)``), in the layout ``want``
    (``relayout``).  ``use`` says how the ranks of a model group use a
    weight that ``want`` leaves whole over ``model``: ``"whole"``, each
    computes the same thing with it; ``"part"``, each computes its own
    part (so a weight replicated over ``model`` takes ``copy_to``).
    Without a mesh, ``p[name]`` itself."""
    if current_mesh() is None:
        return p[name]
    have = param_spec(name, shape)
    w = relayout(p[name], have, want, whole=use == "whole")
    if use == "part" and "model" not in have and "model" not in want:
        w = copy_to(w, "model")
    return w


def model_cut(name: str, shape, dim: int) -> str | None:
    """``"model"`` where ``param_spec(name, shape)`` cuts ``dim`` over the
    model axis of the active mesh and that axis has more than one rank,
    else ``None``."""
    if axis_size("model") == 1:
        return None
    spec = param_spec(name, shape)
    return "model" if dim < len(spec) and spec[dim] == "model" else None
