"""JumpHash on torch tensors — the plain versions of the jump kernels.

The ω-step chain of ``repro_torch.core.jump.jump_lookup32`` over a whole
batch: every lane runs all ω steps and ``done`` freezes each lane's bucket
at its first exit (the kernel leaves its loop there instead).  The 64-bit
LCG state lives in an int64 tensor (multiplication and addition wrap mod
2^64 on the bits; the right shift is made logical).  Each step is IEEE
single precision: ``f32(b+1) * (f32(2^31) / f32(r))``, with the division
taken tensor by tensor — torch computes ``scalar / tensor`` as a reciprocal
times the scalar, which rounds twice.
"""
from __future__ import annotations

import torch

from repro_torch.core.binomial_torch import MASK32, _shr64, mix64_lo32, u32
from repro_torch.core.jump import JUMP_LCG
from repro_torch.core.memento_torch import fused_route_impl


def jump_unrolled_body(keys: torch.Tensor, n: torch.Tensor, omega: int) -> torch.Tensor:
    """u32 keys + u32 n (0-dim tensor) -> u32 buckets in [0, n).

    Exited lanes' f32 products reach ~2^51; their int64 cast is masked off
    by ``done``, and continuing lanes satisfy ``fj < n <= 2^24``.
    """
    k = keys
    b = torch.zeros_like(keys)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    fn = n.to(torch.float32)
    top = torch.tensor(2.0**31, dtype=torch.float32, device=keys.device)
    for _ in range(omega):
        k = k * JUMP_LCG + 1
        r = _shr64(k, 33) + 1
        fj = (b + 1).to(torch.float32) * torch.div(top, r.to(torch.float32))
        exits = fj >= fn
        b = torch.where(~done & ~exits, fj.to(torch.int64), b)
        done = done | exits
    return torch.where(n <= 1, 0, b)


def jump_lookup_dyn(keys: torch.Tensor, n, omega: int = 16) -> torch.Tensor:
    """Bulk jump lookup, n a runtime value (int or 1-element tensor):
    any-int keys -> int32 buckets."""
    n = u32(n).to(keys.device).reshape(())
    return jump_unrolled_body(u32(keys), n, omega).to(torch.int32)


def jump_fold(n: int) -> tuple[int, int]:
    """The static-n kernel's host constants for jump: none (``(0, 0)``);
    raises OverflowError for n past u32, as the reference does."""
    if n > MASK32:
        raise OverflowError(f"n = {n} is out of bounds for uint32")
    return 0, 0


def jump_lookup_vec(keys: torch.Tensor, n: int, omega: int = 16) -> torch.Tensor:
    """Bulk jump lookup, n a static Python int: any-int keys -> int32
    buckets; n <= 1 gives zeros, and n past u32 raises OverflowError as the
    reference's ``np.uint32(n)`` does."""
    keys = u32(keys)
    if n <= 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    jump_fold(n)
    n_t = torch.tensor(n, dtype=torch.int64, device=keys.device)
    return jump_unrolled_body(keys, n_t, omega).to(torch.int32)


def jump_memento_route(keys, packed, table, state, omega: int = 16) -> torch.Tensor:
    """Plain version of the jump route kernel: keys -> int32 replica ids."""
    return fused_route_impl(keys, packed, table, state, omega, lookup=jump_unrolled_body)


def jump_ingest_route(ids_lo, ids_hi, packed, table, state, omega: int = 16) -> torch.Tensor:
    """Plain version of the jump ingest kernel: u64 ids as u32 halves ->
    int32 replica ids."""
    keys = mix64_lo32(ids_lo, ids_hi).reshape(ids_lo.shape)
    return fused_route_impl(keys, packed, table, state, omega, lookup=jump_unrolled_body)
