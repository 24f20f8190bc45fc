"""The torch u32 primitives of ``repro_torch.core.binomial_torch`` against
the JAX reference ``repro.core.binomial_jax``, bit for bit (tolerance 0:
every value is an integer), on seeded random u32 values plus the edges
0, 1, 2^31 and 2^32-1."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import binomial_jax as ref  # noqa: E402
from repro_torch.core import binomial_torch as port  # noqa: E402
from repro_torch.core import jump_torch  # noqa: E402
from repro.core import jump_jax  # noqa: E402

EDGES = np.array([0, 1, 2, 3, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint32)


def _u32(seed: int, size: int = 4096) -> np.ndarray:
    x = np.random.default_rng(seed).integers(0, 2**32, size=size, dtype=np.uint32)
    return np.concatenate([EDGES, x])


def _t(x: np.ndarray) -> torch.Tensor:
    """u32 numpy -> the port's int32 bit-pattern layout."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _port_u32(t: torch.Tensor) -> np.ndarray:
    return (t.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


def _ref_u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


@pytest.mark.parametrize("name", ["mix32", "next_pow2_u32"])
def test_unary_primitive(name):
    x = _u32(1)
    got = _port_u32(getattr(port, name)(port.u32(_t(x))))
    np.testing.assert_array_equal(got, _ref_u32(getattr(ref, name)(jnp.asarray(x))))


@pytest.mark.parametrize("name", ["hash_pair", "mulhi32", "relocate_within_level"])
def test_binary_primitive(name):
    a, b = _u32(2), _u32(3)
    # every edge against every edge, then random pairs
    ea, eb = (g.reshape(-1) for g in np.meshgrid(EDGES, EDGES))
    a, b = np.concatenate([ea, a]), np.concatenate([eb, b])
    got = _port_u32(getattr(port, name)(port.u32(_t(a)), port.u32(_t(b))))
    np.testing.assert_array_equal(
        got, _ref_u32(getattr(ref, name)(jnp.asarray(a), jnp.asarray(b)))
    )


def test_relocate_within_level_small_levels():
    """b < 2 passes through; each level [2^d, 2^(d+1)) maps into itself."""
    b = np.arange(0, 4096, dtype=np.uint32)
    h = _u32(4, size=b.size - EDGES.size)
    got = _port_u32(port.relocate_within_level(port.u32(_t(b)), port.u32(_t(h))))
    np.testing.assert_array_equal(
        got, _ref_u32(ref.relocate_within_level(jnp.asarray(b), jnp.asarray(h)))
    )
    np.testing.assert_array_equal(got[:2], [0, 1])


def test_mix64_lo32():
    lo, hi = _u32(5), _u32(6)
    ea, eb = (g.reshape(-1) for g in np.meshgrid(EDGES, EDGES))
    lo, hi = np.concatenate([ea, lo]), np.concatenate([eb, hi])
    got = _port_u32(port.mix64_lo32(_t(lo), _t(hi)))
    np.testing.assert_array_equal(got, _ref_u32(ref.mix64_lo32(jnp.asarray(lo), jnp.asarray(hi))))


@pytest.mark.parametrize("omega", [1, 2, 16, 32])
@pytest.mark.parametrize("n", [2, 3, 5, 37, 64, 1000, (1 << 16) + 1])
def test_unrolled_body(n, omega):
    keys = _u32(7, size=1024)
    E = 1 << (n - 1).bit_length()
    got = _port_u32(port._unrolled_body(port.u32(_t(keys)), E, E >> 1, n, omega))
    expect = ref._unrolled_body(
        jnp.asarray(keys), np.uint32(E), np.uint32(E >> 1), np.uint32(n), omega
    )
    np.testing.assert_array_equal(got, _ref_u32(expect))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 1000, (1 << 24) - 1, 1 << 24])
def test_binomial_lookup_dyn(n):
    keys = _u32(8, size=2048)
    got = port.binomial_lookup_dyn(_t(keys), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.binomial_lookup_dyn(jnp.asarray(keys), n)))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 1000, (1 << 24) - 1, 1 << 24])
def test_jump_lookup_dyn(n):
    keys = _u32(9, size=2048)
    got = jump_torch.jump_lookup_dyn(_t(keys), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(jump_jax.jump_lookup_dyn(jnp.asarray(keys), n)))


def test_tensor_n_matches_int_n():
    """n given as a 1-element int32 tensor (the device layout) == int n."""
    keys = _t(_u32(10, size=512))
    for fn in (port.binomial_lookup_dyn, jump_torch.jump_lookup_dyn):
        np.testing.assert_array_equal(
            fn(keys, torch.tensor([777], dtype=torch.int32)).numpy(), fn(keys, 777).numpy()
        )
