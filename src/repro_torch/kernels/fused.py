"""The routing kernels' wrappers: for each engine, ``route``, ``ingest``,
``lookup_dyn``, ``lookup_vec``, ``lookup_router`` (the static-n kernel
building the MoE hash router's keys from token ids), ``route_load`` (the
route with the load monitor's per-shard count in the same launch), and the
R-way placement's ``route_family`` (the route kernel over a key's ``r``
salted families) and ``resolve`` (the distinct-resolution pass), each
beside its plain torch version and with a launch count.

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
                of ``repro.core.jump_jax.jump_lookup_vec``); ``lookup_router``
                runs the same kernel over the router's keys (the key build
                of ``repro.models.layers.moe.route`` moved into it)
    route_family the route kernel over a placement's salted key families
                (the family route of ``repro.placement.store.route_replicas_impl``,
                store.py:87, which runs the fused route, pallas_call at
                fused.py:202, on TPU); ``resolve`` is that function's
                distinct-resolution pass, which the reference computes
                outside any Pallas kernel
    route_load  the instrumented route of
                ``repro.observability.load.route_with_load_impl``
                (load.py:71-118; jnp in the reference, no Pallas kernel)

Operands: keys and id halves are int32 tensors holding u32 bit patterns;
the fleet operands are those of ``repro_torch.core.bulk.FleetState``
(packed mask ``(W,)``, table ``(C,)``, state ``(2,)``, all int32); ``n`` of
``lookup_dyn`` is a 1-element int32 tensor, that of ``lookup_vec`` a Python
int.  Outputs are int32 tensors of the keys' shape (``lookup_router``: the
token ids' shape plus ``top_k``; ``route_family`` and ``resolve``: the
keys' count by ``r``).  ``route_load``'s accumulator is a ``(capacity,)``
int32 tensor of u32 bit patterns, advanced in place.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.core.binomial_torch import (
    MASK32,
    binomial_lookup_dyn,
    binomial_lookup_vec,
    fold_pow2,
    router_keys,
)
from repro_torch.core.jump_torch import (
    jump_fold,
    jump_ingest_route,
    jump_lookup_dyn,
    jump_lookup_vec,
    jump_memento_route,
)
from repro_torch.core.memento_torch import binomial_ingest_route, binomial_memento_route
from repro_torch.core.placement_torch import family_keys, resolve_columns
from repro_torch.kernels import build
from repro_torch.observability.load import route_with_load_impl

#: kernel kinds, as the launch counts are keyed
KINDS = ("route", "ingest", "lookup_dyn", "lookup_vec", "route_family", "resolve", "route_load")


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
    """One engine's kernels.

    ``launches[kind]`` grows by one at each kernel launch and nowhere else
    (plain-version calls do not count; ``lookup_router`` counts under
    ``lookup_vec``, whose kernel it launches; ``resolve``, the same kernel
    for both engines, counts under the engine whose placement called it).
    ``fold(n)`` gives the static-n kernel's host constants ``(E, M)`` and
    raises where the reference does.
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

    def route_load_plain(self, keys, packed, table, state, counts, omega: int = 16,
                         sample_shift: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        return route_with_load_impl(keys, packed, table, state, counts, omega=omega,
                               route=self.route_plain, sample_shift=sample_shift)

    def route_load(self, keys, packed, table, state, counts, omega: int = 16,
                   sample_shift: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """The route plus the load monitor's count, in one launch: keys ->
        ``(replicas, counts)``, the replicas ``route``'s and ``counts`` (the
        ``(capacity,)`` int32 accumulator of u32 bit patterns) advanced in
        place by ``2**sample_shift`` at the replica of every flat index that
        is a multiple of ``2**sample_shift``, wrapping as u32.  A CPU
        accumulator is advanced in place by the plain version too."""
        if not 0 <= sample_shift <= 31:
            raise ValueError(f"sample_shift must be in [0, 31], got {sample_shift}")
        if counts.numel() != table.numel():
            raise ValueError(
                f"the accumulator holds {counts.numel()} bins; the fleet's capacity is "
                f"{table.numel()}"
            )
        if _on_cpu(keys, packed, table, state, counts):
            out, new = self.route_load_plain(keys, packed, table, state, counts, omega,
                                             sample_shift)
            counts.copy_(new)
            return out, counts
        _check_state(state)
        out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
        if keys.numel():
            with torch.cuda.device(keys.device):
                rc = build.library().routing_route_load(
                    self.engine_id, _ptr(keys), _ptr(packed), packed.numel(), _ptr(table),
                    table.numel(), _ptr(state), omega, _ptr(out), keys.numel(), _ptr(counts),
                    counts.numel(), sample_shift, _stream(keys),
                )
            _check(rc, f"{self.name} route_load")
            self.launches["route_load"] += 1
        return out, counts

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

    def lookup_router_plain(self, token_ids, layer_salt: int, top_k: int, n: int,
                            omega: int = 16) -> torch.Tensor:
        return self.lookup_vec_plain(router_keys(token_ids, layer_salt, top_k), n, omega)

    def lookup_router(self, token_ids, layer_salt: int, top_k: int, n: int,
                      omega: int = 16) -> torch.Tensor:
        """The MoE hash router: token ids (any shape, int32 or int64) ->
        int32 expert ids of shape ``(*token_ids.shape, top_k)``, the static-n
        lookup of ``router_keys(token_ids, layer_salt, top_k)`` over ``n``
        experts, the keys built inside the launch.  n <= 1 gives zeros
        without a launch."""
        if token_ids.device.type == "cpu":
            return self.lookup_router_plain(token_ids, layer_salt, top_k, n, omega)
        if token_ids.device.type != "cuda":
            raise ValueError(f"routing kernels run on CUDA devices, got {token_ids.device}")
        if token_ids.dtype not in (torch.int32, torch.int64) or not token_ids.is_contiguous():
            raise ValueError(
                f"token ids must be a contiguous int32 or int64 tensor, got "
                f"{token_ids.dtype} (contiguous={token_ids.is_contiguous()})"
            )
        if top_k < 1:
            raise ValueError(f"top_k must be positive, got {top_k}")
        shape = (*token_ids.shape, top_k)
        if n <= 1:
            return torch.zeros(shape, dtype=torch.int32, device=token_ids.device)
        E, M = self.fold(n)
        out = torch.empty(shape, dtype=torch.int32, device=token_ids.device)
        if out.numel() >= 1 << 32:
            raise ValueError(f"{out.numel()} router keys: the kernel indexes them in u32")
        if out.numel():
            salt0 = (layer_salt * 1000003) & MASK32
            stride = token_ids.element_size() // 4  # the low word of each id
            with torch.cuda.device(token_ids.device):
                rc = build.library().routing_lookup_router(
                    self.engine_id, _ptr(token_ids), stride, salt0, top_k, n, E, M,
                    omega, _ptr(out), out.numel(), _stream(token_ids),
                )
            _check(rc, f"{self.name} lookup_router")
            self.launches["lookup_vec"] += 1
        return out

    # -- R-way placement ----------------------------------------------------
    def route_family_plain(self, keys, r: int, packed, table, state,
                           omega: int = 16) -> torch.Tensor:
        return self.route_plain(family_keys(keys, r), packed, table, state, omega)

    def route_family(self, keys, r: int, packed, table, state, omega: int = 16) -> torch.Tensor:
        """The fused route over each key's ``r`` salted families: keys (N,)
        -> ``(N, r)`` int32 replica ids, column ``j`` the route of
        ``mix32(key ^ family_salts(r)[j])``, in one launch (the family keys
        are built in it; no ``(N, r)`` key array exists), for any ``r >= 1``."""
        if _on_cpu(keys, packed, table, state):
            return self.route_family_plain(keys, r, packed, table, state, omega)
        if r < 1:
            raise ValueError(f"the placement kernels take r >= 1, got {r}")
        _check_state(state)
        out = torch.empty((keys.numel(), r), dtype=torch.int32, device=keys.device)
        if out.numel() >= 1 << 32:
            raise ValueError(f"{out.numel()} family keys: the kernel indexes them in u32")
        if out.numel():
            with torch.cuda.device(keys.device):
                rc = build.library().routing_route_family(
                    self.engine_id, _ptr(keys), r, _ptr(packed), packed.numel(), _ptr(table),
                    table.numel(), _ptr(state), omega, _ptr(out), out.numel(), _stream(keys),
                )
            _check(rc, f"{self.name} route_family")
            self.launches["route_family"] += 1
        return out

    resolve_plain = staticmethod(resolve_columns)

    def resolve(self, keys, base, table, state, max_resalt: int, old=None):
        """The distinct-resolution pass: keys (N,) and their routed family
        columns ``base`` (N, r) -> ``(replicas (N, r) int32, exhausted (N,)
        bool, moved (N, r) bool or None)``, as ``resolve_columns`` says;
        with ``old`` (N, r) the same launch computes the moved mask.  The
        kernel keeps a key's columns in registers up to ``MAX_R`` and reads
        them back from its row of the output beyond: any ``r >= 1``."""
        operands = (keys, base, table, state) + (() if old is None else (old,))
        if _on_cpu(*operands):
            return self.resolve_plain(keys, base, table, state, max_resalt, old)
        _check_state(state)
        n, r = keys.numel(), base.shape[-1]
        if base.numel() != n * r or r < 1 or (
                old is not None and old.shape != base.shape):
            raise ValueError(
                f"resolve takes (N,) keys with (N, r) columns, r >= 1: got keys "
                f"{tuple(keys.shape)}, base {tuple(base.shape)}"
                + ("" if old is None else f", old {tuple(old.shape)}")
            )
        if max_resalt < 0:
            raise ValueError(f"max_resalt must be >= 0, got {max_resalt}")
        out = torch.empty((n, r), dtype=torch.int32, device=keys.device)
        exhausted = torch.empty(n, dtype=torch.bool, device=keys.device)
        moved = None if old is None else torch.empty((n, r), dtype=torch.bool, device=keys.device)
        if n:
            with torch.cuda.device(keys.device):
                rc = build.library().routing_resolve(
                    _ptr(keys), _ptr(base), _ptr(table), _ptr(state), r, max_resalt,
                    None if old is None else _ptr(old), _ptr(out), _ptr(exhausted),
                    None if moved is None else _ptr(moved), n, _stream(keys),
                )
            _check(rc, f"{self.name} resolve")
            self.launches["resolve"] += 1
        return out, exhausted, moved


BINOMIAL = RoutingKernels(
    "binomial", 0, binomial_memento_route, binomial_ingest_route, binomial_lookup_dyn,
    binomial_lookup_vec, fold_pow2,
)
JUMP = RoutingKernels(
    "jump", 1, jump_memento_route, jump_ingest_route, jump_lookup_dyn, jump_lookup_vec,
    jump_fold,
)
