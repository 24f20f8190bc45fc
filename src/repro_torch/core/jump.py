"""JumpHash in the device word sizes — the scalar oracle of the jump engine.

Jump consistent hash (Lamping & Veach, 2014) walks a chain of candidate
buckets ``j <- floor((b+1) * 2^31 / ((k >> 33) + 1))`` driven by a 64-bit
LCG.  ``jump32`` is the device-word flavour the kernels implement: a u32
key seeds the u64 LCG, each step is taken in IEEE single precision
(``f32(b+1) * (f32(2^31) / f32(r))``, round-to-nearest), and the chain is
cut after ``omega`` steps, keeping the latest candidate (always < n).
``b+1`` must be exact in an f32 mantissa, which bounds the slot space at
2^24 (``repro_torch.core.bulk.MAX_CAPACITY``).

The vectorised torch body is ``repro_torch.core.jump_torch``; the CUDA
kernel's is ``Jump::lookup`` in ``kernels/csrc/routing.cuh``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: the 64-bit LCG multiplier from the paper (Lamping & Veach, 2014)
JUMP_LCG = 2862933555777941757

_F_TOP = np.float32(2.0**31)


def jump_lookup32(key: int, n: int, omega: int = 16) -> int:
    """u32-key, ω-bounded, f32-step jump lookup — the ``jump32`` scalar."""
    if n <= 1:
        return 0
    k = key & 0xFFFFFFFF
    b = 0
    fn = np.float32(n)
    for _ in range(omega):
        k = (k * JUMP_LCG + 1) & ((1 << 64) - 1)
        r = (k >> 33) + 1  # uniform in [1, 2^31]
        fj = np.float32(np.float32(b + 1) * np.float32(_F_TOP / np.float32(r)))
        if fj >= fn:
            return b
        b = int(fj)
    return b  # budget exhausted: the latest candidate is always < n


@dataclass
class JumpHash32:
    """Scalar ``jump32`` engine (``get_bucket`` / LIFO add / remove);
    ``omega`` is the step bound shared with the kernels."""

    n: int
    omega: int = 16
    name = "jump32"
    exact = False  # device-word flavour of the published algorithm

    def get_bucket(self, key: int) -> int:
        return jump_lookup32(key, self.n, self.omega)

    def add_bucket(self) -> int:
        self.n += 1
        return self.n - 1

    def remove_bucket(self) -> int:
        if self.n <= 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        return self.n

    @property
    def size(self) -> int:
        return self.n
