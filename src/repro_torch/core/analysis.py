"""Closed-form theory from the paper (§5.4) — balance bounds; a copy of
the JAX package's ``repro.core.analysis``.

Eq. (1): P(M <= b < n) = (n-M)/n * [1 - ((E-n)/E)^omega]
Eq. (3): relative gap (K - K') / (k/n)
Eq. (5): sigma(n, k) = k/n * sqrt((n-M)/M * ((2M-n)/(2M))^omega)
Eq. (6): sigma_max = q * sqrt(1/(1+omega) * (omega / (2(1+omega)))^omega)

These are validated empirically by the JAX package's
benchmarks/bench_theory.py (not ported yet); the CPU tests hold this copy
against ``repro.core.analysis``.
"""
from __future__ import annotations

import math

from repro_torch.core.bits import next_pow2


def tree_bounds(n: int) -> tuple[int, int]:
    """(E, M): enclosing- and minor-tree capacities for cluster size n > 1."""
    if n <= 1:
        raise ValueError("n must be > 1")
    E = next_pow2(n)
    M = E // 2
    return E, M


def p_lowest_level(n: int, omega: int) -> float:
    """Eq. (1): probability a key lands on the (partial) lowest level."""
    E, M = tree_bounds(n)
    return (n - M) / n * (1.0 - ((E - n) / E) ** omega)


def expected_keys(n: int, k: int, omega: int) -> tuple[float, float]:
    """(K, K'): expected keys per minor-tree bucket / per lowest-level bucket."""
    E, M = tree_bounds(n)
    p = p_lowest_level(n, omega)
    k_low = p / (n - M) * k if n > M else 0.0
    k_minor = (1.0 - p) / M * k
    return k_minor, k_low


def relative_imbalance(n: int, omega: int) -> float:
    """Eq. (3): (K - K') / (k/n) — independent of k. Max value is 2^-omega."""
    E, M = tree_bounds(n)
    if n == E:  # perfectly balanced when n is a power of two
        return 0.0
    r = (n - M) / M
    return (1.0 / 2**omega) * (1.0 + r) * (1.0 - r) ** omega


def sigma(n: int, k: int, omega: int) -> float:
    """Eq. (5): std-dev of per-bucket key counts (expectation model)."""
    E, M = tree_bounds(n)
    if n == E:
        return 0.0
    return (k / n) * math.sqrt((n - M) / M * ((2 * M - n) / (2 * M)) ** omega)


def sigma_max(q: float, omega: int) -> float:
    """Eq. (6): max of Eq. (5) over n in [M, 2M), with k = q*n."""
    return q * math.sqrt(1.0 / (1 + omega) * (omega / (2.0 * (1 + omega))) ** omega)


def sigma_argmax(M: int, omega: int) -> float:
    """n that maximises Eq. (5): n = (2+omega)/(1+omega) * M."""
    return (2.0 + omega) / (1.0 + omega) * M
