"""The routing kernels' wrappers: for each engine, ``route``, ``ingest``,
``lookup_dyn`` and ``lookup_vec``, each beside its plain torch version and
with a launch count.

A wrapper given CPU tensors returns its plain version's result.  Given CUDA
tensors it launches the hand-written kernel (``csrc/routing.cu``, built by
``repro_torch.kernels.build``) on the current stream, without
synchronising, or raises: there is no fallback.  The kernels replace the
TPU's Pallas kernels of ``repro.kernels.fused.make_fused_kernels``
(instantiated in ``repro.kernels.binomial_hash`` and ``jump_hash``):

    route       ``_kernel_route``      (pallas_call at fused.py:202)
    ingest      ``_kernel_ingest``     (pallas_call at fused.py:255)
    lookup_dyn  ``_kernel_lookup_dyn`` (pallas_call at fused.py:295)
    lookup_vec  ``repro.kernels.binomial_hash._kernel`` (pallas_call at
                binomial_hash.py:91; the jump instance is the card's form
                of ``repro.core.jump_jax.jump_lookup_vec``)

Operands: keys and id halves are int32 tensors holding u32 bit patterns;
the fleet operands are those of ``repro_torch.core.bulk.FleetState``
(packed mask ``(W,)``, table ``(C,)``, state ``(2,)``, all int32); ``n`` of
``lookup_dyn`` is a 1-element int32 tensor, that of ``lookup_vec`` a Python
int.  Outputs are int32 tensors of the keys' shape.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.core.binomial_torch import binomial_lookup_dyn, binomial_lookup_vec, fold_pow2
from repro_torch.core.jump_torch import (
    jump_fold,
    jump_ingest_route,
    jump_lookup_dyn,
    jump_lookup_vec,
    jump_memento_route,
)
from repro_torch.core.memento_torch import binomial_ingest_route, binomial_memento_route
from repro_torch.kernels import build

#: kernel kinds, as the launch counts are keyed
KINDS = ("route", "ingest", "lookup_dyn", "lookup_vec")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU operands (plain version); False for CUDA operands on
    one device in the kernels' layout; raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"routing kernels run on CUDA devices, got {device}")
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"kernel operands must be contiguous int32 tensors, got "
                f"{t.dtype} (contiguous={t.is_contiguous()})"
            )
    return False


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: cuda error {rc}")


def _check_state(state: torch.Tensor) -> None:
    if state.numel() != 2:
        raise ValueError(f"state must hold [n_total, n_alive], got {state.numel()} elements")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


class RoutingKernels:
    """One engine's four kernels.

    ``launches[kind]`` grows by one at each kernel launch and nowhere else
    (plain-version calls do not count).  ``fold(n)`` gives the static-n
    kernel's host constants ``(E, M)`` and raises where the reference does.
    """

    def __init__(
        self, name: str, engine_id: int, route_plain: Callable,
        ingest_plain: Callable, lookup_dyn_plain: Callable,
        lookup_vec_plain: Callable, fold: Callable[[int], tuple[int, int]],
    ):
        self.name = name
        self.engine_id = engine_id  # the C entry points' engine switch
        self.route_plain = route_plain
        self.ingest_plain = ingest_plain
        self.lookup_dyn_plain = lookup_dyn_plain
        self.lookup_vec_plain = lookup_vec_plain
        self.fold = fold
        self.launches = dict.fromkeys(KINDS, 0)

    def reset_launches(self) -> None:
        self.launches = dict.fromkeys(KINDS, 0)

    def route(self, keys, packed, table, state, omega: int = 16) -> torch.Tensor:
        """Fused lookup + table divert: keys -> int32 replica ids."""
        if _on_cpu(keys, packed, table, state):
            return self.route_plain(keys, packed, table, state, omega)
        _check_state(state)
        out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
        if keys.numel():
            with torch.cuda.device(keys.device):
                rc = build.library().routing_route(
                    self.engine_id, _ptr(keys), _ptr(packed), packed.numel(),
                    _ptr(table), table.numel(), _ptr(state), omega, _ptr(out),
                    keys.numel(), _stream(keys),
                )
            _check(rc, f"{self.name} route")
            self.launches["route"] += 1
        return out

    def ingest(self, ids_lo, ids_hi, packed, table, state, omega: int = 16) -> torch.Tensor:
        """Fused splitmix64 ingest + lookup + divert: u64 ids as u32 halves
        -> int32 replica ids."""
        if ids_lo.shape != ids_hi.shape:
            raise ValueError(
                f"id halves must agree in shape, got {tuple(ids_lo.shape)} "
                f"vs {tuple(ids_hi.shape)}"
            )
        if _on_cpu(ids_lo, ids_hi, packed, table, state):
            return self.ingest_plain(ids_lo, ids_hi, packed, table, state, omega)
        _check_state(state)
        out = torch.empty(ids_lo.shape, dtype=torch.int32, device=ids_lo.device)
        if ids_lo.numel():
            with torch.cuda.device(ids_lo.device):
                rc = build.library().routing_ingest(
                    self.engine_id, _ptr(ids_lo), _ptr(ids_hi), _ptr(packed),
                    packed.numel(), _ptr(table), table.numel(), _ptr(state),
                    omega, _ptr(out), ids_lo.numel(), _stream(ids_lo),
                )
            _check(rc, f"{self.name} ingest")
            self.launches["ingest"] += 1
        return out

    def lookup_dyn(self, keys, n, omega: int = 16) -> torch.Tensor:
        """Bare lookup with n read on the device: keys -> int32 buckets."""
        if _on_cpu(keys, n):
            return self.lookup_dyn_plain(keys, n, omega)
        if n.numel() != 1:
            raise ValueError(f"n must hold one element, got {n.numel()}")
        out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
        if keys.numel():
            with torch.cuda.device(keys.device):
                rc = build.library().routing_lookup_dyn(
                    self.engine_id, _ptr(keys), _ptr(n), omega, _ptr(out),
                    keys.numel(), _stream(keys),
                )
            _check(rc, f"{self.name} lookup_dyn")
            self.launches["lookup_dyn"] += 1
        return out


    def lookup_vec(self, keys, n: int, omega: int = 16) -> torch.Tensor:
        """Bare lookup with n a static Python int: keys -> int32 buckets.
        n <= 1 gives zeros without a launch."""
        if _on_cpu(keys):
            return self.lookup_vec_plain(keys, n, omega)
        if n <= 1:
            return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
        E, M = self.fold(n)
        out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
        if keys.numel():
            with torch.cuda.device(keys.device):
                rc = build.library().routing_lookup_vec(
                    self.engine_id, _ptr(keys), n, E, M, omega, _ptr(out),
                    keys.numel(), _stream(keys),
                )
            _check(rc, f"{self.name} lookup_vec")
            self.launches["lookup_vec"] += 1
        return out


BINOMIAL = RoutingKernels(
    "binomial", 0, binomial_memento_route, binomial_ingest_route, binomial_lookup_dyn,
    binomial_lookup_vec, fold_pow2,
)
JUMP = RoutingKernels(
    "jump", 1, jump_memento_route, jump_ingest_route, jump_lookup_dyn, jump_lookup_vec,
    jump_fold,
)
