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


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over mesh axis
    ``axis`` (a tiled all-gather), in the axis's rank order."""
    import torch.distributed as dist

    mesh = current_mesh()
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return x
    g = mesh.get_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum ``x`` over mesh axis ``axis`` (in place; returns ``x``)."""
    import torch.distributed as dist

    mesh = current_mesh()
    if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
        dist.all_reduce(x, group=mesh.get_group(axis))
    return x
