"""What the multi-rank tests share (this module holds no test of its own):
gloo ranks on the CPU, and the reference's meshed runs in a subprocess.

``spawn(fn, world, tmp_path, *args)`` runs ``fn(rank, world, *args)`` in
``world`` spawned processes joined in one gloo process group.  The group
meets on a ``FileStore`` under ``tmp_path``, so concurrent test workers
never fight over a TCP port, and the ranks are joined with a timeout of
``JOIN_TIMEOUT`` seconds, so a hung collective fails the test instead of
hanging the suite.  Each rank's return value is pickled under
``tmp_path`` and handed back in rank order.  Ranks import this module (and
through it only torch, numpy and the port), never JAX.

``reference(script, tmp_path, *argv)`` runs a script of the JAX package in
a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(four CPU devices; the pytest process never sets it) and returns what it
saved with ``numpy.savez`` to the path it is given as ``sys.argv[1]``.
Under JAX 0.9 a reference mesh must be built with
``axis_types=(AxisType.Auto,) * k``: the default Explicit axes refuse the
reference's mesh paths.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

#: seconds the ranks of one spawn may take before the test fails
JOIN_TIMEOUT = 120

SRC = Path(__file__).resolve().parents[1] / "src"


def _entry(rank, world, store, out_dir, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world: int, tmp_path: Path, *args) -> list:
    import torch.multiprocessing as mp

    out_dir = tmp_path / f"ranks{world}"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _entry, args=(world, str(out_dir / "store"), str(out_dir), fn, args),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish within {JOIN_TIMEOUT} s")
    results = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def reference(script: str, tmp_path: Path, *argv) -> dict:
    pytest.importorskip("jax")
    out = tmp_path / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    run = subprocess.run([sys.executable, "-c", script, str(out), *map(str, argv)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, f"stdout:\n{run.stdout}\nstderr:\n{run.stderr}"
    with np.load(out) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# rank functions (run in the spawned processes)
# ---------------------------------------------------------------------------

#: the reference's event stream of ``tests/test_sharded_routing.py``
EVENTS = [("fail", 3), ("scale_up", None), ("fail", 7), ("scale_down", None),
          ("recover", 3), ("scale_up", None), ("fail", 0), ("recover", 7)]
ENGINES = ("binomial", "jump")


def _refused(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def sharded_route_rank(rank, world, keys):
    """The port's sharded routing on this rank: per engine, the whole
    batch's ids (``route_keys_np``) and this rank's block after each event
    of ``EVENTS``, beside the single-device port and the scalar oracle; the
    padding batch; ``make_sharded_route`` alone; donation; refusals."""
    from repro_torch.core.bulk import RouterSpec
    from repro_torch.core.registry import make_bulk
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serving.batch_router import BatchRouter
    from repro_torch.serving.router import SessionRouter

    mesh = make_local_mesh(world, 1, device_type="cpu")
    lo, hi, _ = ops.shard_bounds(keys.size, world, rank)
    sample = np.random.default_rng(rank).choice(keys.size, size=256, replace=False)
    res = {"bounds": (lo, hi)}
    for engine in ENGINES:
        sharded = BatchRouter(16, mesh=mesh, engine=engine)
        single = BatchRouter(16, engine=engine, device="cpu")
        oracle = SessionRouter(16, engine=make_bulk(engine).scalar_engine, chain_bits=32,
                               resolve="table")
        for step in range(len(EVENTS) + 1):
            if step:
                ev, arg = EVENTS[step - 1]
                for r in (sharded, single, oracle):
                    getattr(r, ev)(*(() if arg is None else (arg,)))
            out = sharded.route_keys(keys)
            res[f"{engine}/{step}/local"] = out.to_local().numpy().copy()
            res[f"{engine}/{step}/placements"] = repr(out.placements)
            res[f"{engine}/{step}/full"] = sharded.route_keys_np(keys)
            res[f"{engine}/{step}/single"] = single.route_keys_np(keys)
            res[f"{engine}/{step}/oracle"] = np.array(
                [oracle.domain.locate(int(keys[j])) for j in sample])
            res[f"{engine}/{step}/sample"] = sample
        odd = keys[:10_001]
        res[f"{engine}/pad"] = sharded.route_keys_np(odd)
        res[f"{engine}/pad/local"] = sharded.route_keys(odd).to_local().numpy().copy()
        for shape in ((4, 2500), (3, 3333)):
            batch = keys[: shape[0] * shape[1]].reshape(shape)
            res[f"{engine}/2d/{shape}"] = sharded.route_keys_np(batch)
            res[f"{engine}/2d/{shape}/dtensor"] = sharded.route_keys(batch).full_tensor().numpy()
        # make_sharded_route alone: the whole batch on every rank, one
        # launch on this rank's block, a DTensor of the whole batch
        spec = RouterSpec(engine=engine, capacity=sharded.capacity)
        route = ops.make_sharded_route(mesh, spec)
        kt = torch.from_numpy(keys.astype(np.uint32).view(np.int32))
        got = route(kt, sharded._fleet_dev)
        res[f"{engine}/direct"] = got.full_tensor().numpy()
        res[f"{engine}/direct/refuses_odd"] = _refused(lambda: route(kt[:10_001], sharded._fleet_dev))
        # donation: the spec's route writes the ids into the key buffer ...
        donate = ops.make_sharded_route(mesh, RouterSpec(engine=engine, capacity=sharded.capacity,
                                                         donate_keys=True))
        buf = kt.clone()
        got = donate(buf, sharded._fleet_dev).to_local()
        res[f"{engine}/donated_in_place"] = bool(
            torch.equal(buf[lo:hi], got) and got.data_ptr() == buf[lo:hi].data_ptr())
        # ... and the router never writes into a buffer the caller owns
        donating = BatchRouter(16, mesh=mesh, engine=engine, donate_keys=True)
        before, kt_before = keys.copy(), kt.clone()
        first, second = donating.route_keys_np(keys), donating.route_keys_np(keys)
        third, fourth = donating.route_keys_np(kt), donating.route_keys_np(kt)
        res[f"{engine}/donate"] = (first, second, third, fourth)
        res[f"{engine}/donate/callers_intact"] = bool(
            np.array_equal(keys, before) and torch.equal(kt, kt_before))
        res[f"{engine}/donate/fresh"] = BatchRouter(16, engine=engine, device="cpu").route_keys_np(keys)
    res["refusals"] = {
        "two_pass": _refused(lambda: BatchRouter(16, mesh=mesh, fused=False)),
        "donate_without_mesh": _refused(lambda: BatchRouter(16, donate_keys=True, device="cpu")),
        "route_ids": _refused(lambda: BatchRouter(16, mesh=mesh).route_ids(np.arange(8))),
        "load_monitor": _refused(lambda: BatchRouter(16, mesh=mesh).attach_load_monitor(None)),
        "unknown_axis": _refused(lambda: BatchRouter(16, mesh=mesh, shard_axis="pod")),
        "spec_and_fields": _refused(lambda: BatchRouter(16, RouterSpec(), mesh=mesh, engine="jump")),
    }
    counted = BatchRouter(16, mesh=mesh)
    counted.route_keys(keys[:100])
    res["lookups"] = counted.stats.lookups
    return res


#: the MoE cases of ``tests/test_torch_moe_mesh.py``: router, capacity
#: factor, (B, S), fsdp, expert layout
MOE_CASES = [
    (router, cf, bs, fsdp, lay)
    for router in ("hash", "topk")
    for cf in (8.0, 0.5)
    for bs in ((4, 16), (4, 1))
    for fsdp in (False, True)
    for lay in ("ep", "tp")
]


def moe_case_name(router, cf, bs, fsdp, lay) -> str:
    return f"{router}/{cf}/{bs[0]}x{bs[1]}/{'fsdp' if fsdp else 'nofsdp'}/{lay}"


def moe_config(router: str, cf: float):
    """The port's reduced Qwen3-MoE in float32 with ``router`` and capacity
    factor ``cf``."""
    import dataclasses

    from repro_torch.configs import reduced_config

    cfg = reduced_config("qwen3-moe-235b-a22b")
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               moe=dataclasses.replace(cfg.moe, router=router,
                                                       capacity_factor=cf))


def moe_mesh_rank(rank, world, arrays):
    """``apply_moe`` on a (2, 2) ``("data", "model")`` mesh: each rank holds
    its block of the expert weights and its data shard of the tokens, and
    returns its shard of the output and the aux loss, per case."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import moe
    from repro_torch.sharding import rules

    mesh = make_local_mesh(2, 2, device_type="cpu")
    data = rules.coordinate(mesh)["data"]
    out = {}
    for case in MOE_CASES:
        name = moe_case_name(*case)
        router, cf, (B, S), fsdp, lay = case
        cfg = moe_config(router, cf)
        full = {k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith("p/")}
        x, tok = arrays[f"{B}x{S}/x"], arrays[f"{B}x{S}/tok"]
        rows = slice(data * B // 2, (data + 1) * B // 2)
        with rules.mesh_context(mesh, fsdp=fsdp, expert_layout=lay), torch.inference_mode():
            p = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in rules.params_local(full).items()}
            y, aux = moe.apply_moe(p, torch.from_numpy(x[rows]), torch.from_numpy(tok[rows]), 3, cfg)
        out[name] = (y.numpy(), float(aux), tuple(p["experts_wi"].shape),
                     tuple(p["experts_wo"].shape))
    return out


def serving_mesh_rank(rank, world, tree, requests, n_new, max_len):
    """``ServingTier(mesh=..., router_spec=...)`` on this rank, through a
    failure of replica 1.  One rank: a (1, 1) mesh, and the model under
    ``mesh_context`` with its parameters cut by ``params_local``, so both
    MoE mesh branches serve (their calls are counted).  Two ranks: a
    (2, 1) mesh that shards the routing datapath over ``data``, the model
    as on one device (every rank serves the whole batch)."""
    import contextlib
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.bulk import RouterSpec
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import moe
    from repro_torch.serving.engine import Request, ServingTier
    from repro_torch.sharding import rules

    cfg = reduced_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router="hash"))
    mesh = make_local_mesh(world, 1, device_type="cpu")
    calls = {"_ep_moe": 0, "_dense_moe": 0}
    for name in calls:
        def counted(*a, _fn=getattr(moe, name), _name=name):
            calls[_name] += 1
            return _fn(*a)
        setattr(moe, name, counted)
    model_mesh = rules.mesh_context(mesh, expert_layout="ep") if world == 1 else contextlib.nullcontext()
    out = {"serves": []}
    with model_mesh:
        params = params_from_numpy(tree, cfg, "cpu", local=world == 1)
        spec = RouterSpec(engine="binomial", capacity=64, shard_axis="data")
        tier = ServingTier(cfg, params, 3, max_len=max_len, mesh=mesh, router_spec=spec)
        try:
            ServingTier(cfg, params, 3, max_len=max_len, mesh=mesh, router_spec=spec,
                        engine="jump")
        except ValueError as e:
            out["clash"] = str(e)
        for failed in (None, 1):
            if failed is not None:
                tier.fail(failed)
            got = tier.serve([Request(s, p, n_new) for s, p in requests])
            out["serves"].append({
                "tokens": got,
                "routes": [tier.router.route(s) for s, _ in requests],
                "batch_routes": tier.router.route_batch([s for s, _ in requests]),
            })
    out["calls"] = calls
    return out
