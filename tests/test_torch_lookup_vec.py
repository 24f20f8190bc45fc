"""The port's static-n lookup (``lookup_vec``, the counterpart of the Pallas
kernel ``repro.kernels.binomial_hash.binomial_bulk_lookup_2d``) against the
JAX package on the same numpy keys: the Pallas kernel in interpret mode and
the jnp ``binomial_lookup_vec``, jump's against ``jump_lookup_vec``, and
the ``ops`` helpers against the reference's.  Tolerance 0: every output is
an integer.  On the CPU the wrappers run their plain versions — what the
CUDA kernel is held against on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.binomial_jax import binomial_lookup_vec  # noqa: E402
from repro.core.jump_jax import jump_lookup_vec  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.binomial_hash import binomial_bulk_lookup_pallas  # noqa: E402
from repro_torch.core.registry import make_bulk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

NS = (0, 1, 2, 3, 11, 127, 128, 129, 1000, 1025, 65536)
OMEGAS = (1, 4, 16, 32)
#: every n at the served omega (16), and every n once more with the omegas
#: in turn, so each n and each omega meets both references; the full
#: n x omega product compiles 88 reference traces (~100 s on a CPU)
CASES = sorted({(n, 16) for n in NS} | {(n, OMEGAS[i % 4]) for i, n in enumerate(NS)})


def _keys(seed: int, size: int = 1500) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, size=size, dtype=np.uint32)


def _port(engine, keys, n, omega=16):
    return make_bulk(engine).kernels.lookup_vec(torch.from_numpy(keys.view(np.int32)), n, omega)


@pytest.mark.parametrize("n, omega", CASES)
def test_binomial_matches_pallas_kernel(n, omega):
    keys = _keys(n)
    want = binomial_bulk_lookup_pallas(jnp.asarray(keys), n, omega=omega, block_rows=8, interpret=True)
    got = _port("binomial", keys, n, omega)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n, omega", CASES)
def test_binomial_matches_jnp_lookup_vec(n, omega):
    keys = _keys(n + 1)
    want = binomial_lookup_vec(jnp.asarray(keys), n, omega=omega)
    np.testing.assert_array_equal(_port("binomial", keys, n, omega).numpy(), np.asarray(want))


@pytest.mark.parametrize("omega", (1, 16))
@pytest.mark.parametrize("n", NS)
def test_jump_matches_jnp_lookup_vec(n, omega):
    keys = _keys(n + 2)
    want = jump_lookup_vec(jnp.asarray(keys), n, omega=omega)
    np.testing.assert_array_equal(_port("jump", keys, n, omega).numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.int32, np.uint32])
def test_any_int_keys_are_truncated_to_u32(dtype):
    wide = np.random.default_rng(5).integers(0, 2**62, size=700).astype(dtype)
    want = binomial_lookup_vec(jnp.asarray(wide.astype(np.uint32)), 1000)
    got = make_bulk("binomial").kernels.lookup_vec(torch.from_numpy(wide.astype(np.int64)), 1000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ops.binomial_bulk_lookup(wide, 1000, device="cpu").numpy(),
                                  np.asarray(want))


def test_huge_n_raises_like_the_reference():
    keys = _keys(9, 16)
    t = torch.from_numpy(keys.view(np.int32))
    with pytest.raises(OverflowError):
        binomial_lookup_vec(jnp.asarray(keys), 2**31 + 1)
    with pytest.raises(OverflowError):
        make_bulk("binomial").kernels.lookup_vec(t, 2**31 + 1)
    np.testing.assert_array_equal(  # 2^31 still folds: E = 2^31
        make_bulk("binomial").kernels.lookup_vec(t, 2**31).numpy(),
        np.asarray(binomial_lookup_vec(jnp.asarray(keys), 2**31)),
    )
    with pytest.raises(OverflowError):
        jump_lookup_vec(jnp.asarray(keys), 2**32)
    with pytest.raises(OverflowError):
        make_bulk("jump").kernels.lookup_vec(t, 2**32)


@pytest.mark.parametrize("n", (0, 1, 2, 1000, 1025))
def test_ops_helpers_match_the_reference(n):
    keys = _keys(20 + n, 2000).reshape(40, 50)
    np.testing.assert_array_equal(
        ops.binomial_bulk_lookup(torch.from_numpy(keys.view(np.int32)), n).numpy(),
        np.asarray(ref_ops.binomial_bulk_lookup(jnp.asarray(keys), n, use_pallas=False)),
    )
    np.testing.assert_array_equal(
        ops.binomial_bulk_lookup_dyn(keys, n, device="cpu").numpy(),
        np.asarray(ref_ops.binomial_bulk_lookup_dyn(jnp.asarray(keys), n, use_pallas=False)),
    )


def test_helpers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.binomial_bulk_lookup(_keys(1, 8), 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.binomial_bulk_lookup_dyn(_keys(1, 8), 10)


def test_n_le_1_gives_zeros_and_counts_no_launch():
    kernels = make_bulk("binomial").kernels
    before = dict(kernels.launches)
    out = kernels.lookup_vec(torch.ones(3, 5, dtype=torch.int32), 1)
    assert out.shape == (3, 5) and not out.any()
    assert kernels.launches == before
