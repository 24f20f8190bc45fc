"""Device meshes for the multi-device path — the counterpart of
``repro.launch.mesh``, built on ``torch.distributed``.

One process per device (multi-controller): every rank runs the same
program, and a ``DeviceMesh`` names the ranks' layout.

Single pod: ``(data=16, model=16)`` = 256 devices.
Multi-pod:  ``(pod=2, data=16, model=16)`` = 512 devices; ``pod`` is pure
data parallelism.

``MeshLayout`` is the layout alone (axis names and sizes, no ranks): the
spec rules of ``repro_torch.sharding.rules`` run against it at the
production shapes in one process, as the JAX package's rules run against
a mesh object.

Functions, not module constants, so that importing this module touches no
process group.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch.distributed as dist

#: the process-group backend each device type implies
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes, with the two views the spec rules
    read: ``axis_names`` (a tuple) and ``shape`` (a name -> size dict)."""

    names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.names) != len(self.sizes) or len(set(self.names)) != len(self.names):
            raise ValueError(f"mesh names {self.names} do not match sizes {self.sizes}")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def layout(mesh) -> MeshLayout:
    """A ``DeviceMesh`` or ``MeshLayout`` -> its ``MeshLayout``."""
    if isinstance(mesh, MeshLayout):
        return mesh
    return MeshLayout(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _ensure_process_group(device_type: str) -> None:
    """Start the default process group with the device type's backend if
    none runs: from the ``torchrun`` environment when it is set, else as a
    world of one rank on an in-memory store."""
    if dist.is_initialized():
        return
    backend = BACKENDS.get(device_type)
    if backend is None:
        raise ValueError(f"no process-group backend for device type {device_type!r}")
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(shape: tuple, names: tuple, device_type: str | None):
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if device_type is None else device_type
    _ensure_process_group(device_type)
    need = MeshLayout(names, shape).size
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"a {dict(zip(names, shape))} mesh needs {need} ranks, the process group has {world}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``; raises unless the process group has
    exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_local_mesh(data: int = 1, model: int = 1, *, device_type: str | None = None):
    """A ``(data, model)`` mesh over the ranks of this host.  ``device_type``
    ``None`` means ``"cuda"`` (NCCL); ``"cpu"`` runs over gloo.  An already
    running process group is used as it is (two ranks sharing one card run
    over gloo that way); with none running, one is started with the device
    type's backend."""
    return _mesh((data, model), ("data", "model"), device_type)


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    """The production mesh's layout, without ranks."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))
