"""The port's mesh-sharded routing datapath (``ops.make_sharded_route``,
``BatchRouter(mesh=...)``) on 2 and 4 gloo ranks on the CPU, against the
JAX package's meshed ``BatchRouter`` (a subprocess with 4 CPU devices and
a mesh of Auto axes), the single-device port and the scalar oracle.

The batch and the event stream are those of ``tests/test_sharded_routing.py``
(2^16 keys from ``default_rng(9)``; fail 3, scale up, fail 7, scale down,
recover 3, scale up, fail 0, recover 7), plus a 10,001-key batch that takes
the padding path, for both engines.  Replica ids must agree bit for bit;
each rank's block of the DTensor must be its ``Shard(0)`` block of the
single-device result.  Also: ``make_sharded_route`` alone, the
``donate_keys`` semantics and the refusals the reference makes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_common import ENGINES, EVENTS, reference, sharded_route_rank, spawn  # noqa: E402

_REFERENCE = r"""
import sys
import jax
import numpy as np
from jax.sharding import AxisType

from repro.serving.batch_router import BatchRouter

EVENTS = %r
assert len(jax.devices()) == 4
rng = np.random.default_rng(9)
keys = rng.integers(0, 2**64, size=(1 << 16,), dtype=np.uint64)
out = {"keys": keys}
for n_dev in (2, 4):
    mesh = jax.make_mesh((n_dev,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:n_dev])
    for engine in ("binomial", "jump"):
        r = BatchRouter(16, mesh=mesh, engine=engine)
        first = r.route_keys(keys)
        assert len(first.addressable_shards) == n_dev
        out[f"{n_dev}/{engine}/0"] = np.asarray(first)
        for i, (ev, arg) in enumerate(EVENTS):
            getattr(r, ev)(*(() if arg is None else (arg,)))
            out[f"{n_dev}/{engine}/{i + 1}"] = np.asarray(r.route_keys(keys))
        out[f"{n_dev}/{engine}/pad"] = np.asarray(r.route_keys(keys[:10_001]))
np.savez(sys.argv[1], **out)
""" % (EVENTS,)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(_REFERENCE, tmp_path_factory.mktemp("ref_route"))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_route_matches_reference_single_device_and_oracle(world, ref, tmp_path):
    keys = ref["keys"]
    ranks = spawn(sharded_route_rank, world, tmp_path, keys)
    for rank, res in enumerate(ranks):
        lo, hi = res["bounds"]
        assert hi - lo == -(-keys.size // world)
        for engine in ENGINES:
            for step in range(len(EVENTS) + 1):
                want = ref[f"{world}/{engine}/{step}"]
                assert np.array_equal(want, ref[f"4/{engine}/{step}"])
                got = res[f"{engine}/{step}/full"]
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(res[f"{engine}/{step}/single"], want)
                np.testing.assert_array_equal(res[f"{engine}/{step}/local"], want[lo:hi])
                sample = res[f"{engine}/{step}/sample"]
                np.testing.assert_array_equal(res[f"{engine}/{step}/oracle"], want[sample])
                assert res[f"{engine}/{step}/placements"] == "(Shard(dim=0), Replicate())"
            # the padding batch: 10,001 keys over `world` blocks
            want = ref[f"{world}/{engine}/pad"]
            np.testing.assert_array_equal(res[f"{engine}/pad"], want)
            plo = min(rank * -(-10_001 // world), 10_001)
            phi = min(plo + -(-10_001 // world), 10_001)
            np.testing.assert_array_equal(res[f"{engine}/pad/local"], want[plo:phi])
            final = ref[f"{world}/{engine}/{len(EVENTS)}"]
            for shape in ((4, 2500), (3, 3333)):
                n = shape[0] * shape[1]
                np.testing.assert_array_equal(res[f"{engine}/2d/{shape}"], final[:n].reshape(shape))
                np.testing.assert_array_equal(res[f"{engine}/2d/{shape}/dtensor"],
                                              final[:n].reshape(shape))
            np.testing.assert_array_equal(res[f"{engine}/direct"], final)
            assert res[f"{engine}/direct/refuses_odd"] is (10_001 % world != 0)
            assert res[f"{engine}/donated_in_place"]
            first, second, third, fourth = res[f"{engine}/donate"]
            for got in (second, third, fourth):
                np.testing.assert_array_equal(got, first)
            np.testing.assert_array_equal(first, res[f"{engine}/donate/fresh"])
            np.testing.assert_array_equal(first, ref[f"{world}/{engine}/0"])
            assert res[f"{engine}/donate/callers_intact"]
        assert all(res["refusals"].values()), res["refusals"]
        assert res["lookups"] == 100
