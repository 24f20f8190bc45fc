"""The CUDA routing kernels on the card: each kernel instance against its
plain torch version (bit-exact), ``BatchRouter`` on the card against the
plain-version router, and a 2-layer hash-routed MoE ``ServingTier`` on the
card against the same tier on the CPU.  Needs a CUDA card and ``nvcc``;
skips elsewhere.
Imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.bulk import FleetState  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.core.registry import BULK_ENGINES  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402
from repro_torch.serving.engine import Request, ServingTier  # noqa: E402
from repro_torch.serving.router import SessionRouter  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fleet(engine, n, capacity, n_fail, seed):
    plane = SessionRouter(n, engine=BULK_ENGINES[engine].scalar_engine)
    for b in np.random.default_rng(seed).choice(n - 1, size=n_fail, replace=False):
        plane.fail(int(b))
    return FleetState.pack(plane.domain, capacity).to("cuda")


def _u32(seed, size, device):
    x = np.random.default_rng(seed).integers(0, 2**32, size=size, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


@pytest.mark.parametrize("fleet", [(1000, 1024, 0), (1000, 1024, 250), (3000, 4096, 900), (2, 64, 0)])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_kernels_match_plain(cuda, engine, fleet):
    k = BULK_ENGINES[engine].kernels
    f = _fleet(engine, *fleet, seed=fleet[2])
    keys, hi = _u32(1, 1 << 16, cuda), _u32(2, 1 << 16, cuda)
    fl = (f.packed, f.table, f.state)
    for omega in (1, 16):
        pairs = [
            (k.route(keys, *fl, omega), k.route_plain(keys, *fl, omega)),
            (k.ingest(keys, hi, *fl, omega), k.ingest_plain(keys, hi, *fl, omega)),
            (k.lookup_dyn(keys, f.state[:1], omega), k.lookup_dyn_plain(keys, f.state[:1], omega)),
        ]
        for got, want in pairs:
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, want.to(torch.int32))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_batch_router_on_card(cuda, engine, fused):
    kernels = BULK_ENGINES[engine].kernels
    kernels.reset_launches()
    gpu = BatchRouter(100, engine=engine, fused=fused)
    cpu = BatchRouter(100, engine=engine, fused=fused, device="cpu")
    keys = _u32(3, 50000, cuda)
    ids = np.random.default_rng(4).integers(0, 2**64, size=5000, dtype=np.uint64)
    for event in (None, ("fail", 7), ("fail", 99), ("scale_up",), ("recover", 7), ("scale_down",)):
        if event:
            getattr(gpu, event[0])(*event[1:]), getattr(cpu, event[0])(*event[1:])
        out = gpu.route_keys(keys)
        assert out.is_cuda
        np.testing.assert_array_equal(out.cpu().numpy(), cpu.route_keys_np(keys.cpu().numpy()))
        np.testing.assert_array_equal(gpu.route_ids(ids).cpu().numpy(), cpu.route_ids(ids).numpy())
    kinds = ("route", "ingest") if fused else ("lookup_dyn",)
    assert all(kernels.launches[kind] > 0 for kind in kinds)


def test_wrappers_refuse_non_int32_on_card(cuda):
    k = BULK_ENGINES["binomial"].kernels
    f = _fleet("binomial", 10, 64, 0, 0)
    with pytest.raises(ValueError, match="int32"):
        k.route(torch.zeros(8, dtype=torch.int64, device=cuda), f.packed, f.table, f.state)
    with pytest.raises(ValueError, match="n_total, n_alive"):
        k.route(torch.zeros(8, dtype=torch.int32, device=cuda), f.packed, f.table, f.state[:1])


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_lookup_vec_matches_plain(cuda, engine):
    k = BULK_ENGINES[engine].kernels
    keys = _u32(5, 1 << 16, cuda)
    for n in (2, 3, 11, 127, 128, 129, 1000, 1025, 65536, 100000):
        for omega in (1, 4, 16, 32):
            got = k.lookup_vec(keys, n, omega)
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, k.lookup_vec_plain(keys, n, omega))
    launched = k.launches["lookup_vec"]
    assert not k.lookup_vec(keys, 1).any() and k.launches["lookup_vec"] == launched


@pytest.mark.parametrize("engine", sorted(BULK_ENGINES))
def test_hash_routed_serving_on_card(cuda, engine):
    cfg = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, num_layers=2, moe=dataclasses.replace(
        cfg.moe, router="hash", router_hash_engine=engine))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    on_card = M.params_to(params, cuda)
    gpu = ServingTier(cfg, on_card, 3, max_len=16, engine=engine)
    cpu = ServingTier(cfg, params, 3, max_len=16, engine=engine, device="cpu")
    rng = np.random.default_rng(6)
    reqs = [Request(f"s-{i}", rng.integers(0, cfg.vocab_size, size=6).astype(np.int32), 4)
            for i in range(12)]
    kernels = BULK_ENGINES[engine].kernels
    kernels.reset_launches()
    for failed in (None, 1):
        if failed is not None:
            gpu.fail(failed), cpu.fail(failed)
        got, want = gpu.serve(reqs), cpu.serve(reqs)
        assert sorted(got) == sorted(want)
        for sid in want:
            np.testing.assert_array_equal(got[sid], want[sid])
    assert kernels.launches["lookup_vec"] > 0 and kernels.launches["route"] == 2
