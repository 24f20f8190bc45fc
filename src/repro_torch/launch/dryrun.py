"""Dry run: rank 0's program of every (arch × shape) cell on the
production meshes, on ``meta`` tensors — the counterpart of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

The reference lowers and compiles each cell for 256 or 512 devices.  Eager
torch has nothing to lower, so each cell runs once what rank 0 of that
mesh would run: the train step (loss, gradients, ZeRO-1 update), the
prefill or the decode step, with its blocks of the parameters, the
optimizer state, the batch and the cache, on ``meta`` tensors (shapes and
dtypes, no storage, nothing computed).  The ranks are a ``"fake"``
process group of 256 or 512 ranks in this one process, whose collectives
return at once; the mesh is a ``DeviceMesh`` over it, so the rules and
collectives run as on a real mesh and ``roofline.analysis`` counts what
they would move.  So the dry run runs on the ``meta`` device by its
nature, not on CUDA.

Per cell, as the reference: the expert layout is ``"tp"`` for an MoE
decode, else ``"ep"``; AdamW below ``ADAFACTOR_THRESHOLD`` parameters,
Adafactor above it; fsdp as the config says.  Each row holds the status,
the chip count, ``n_params``, ``n_active``, the seconds the cell took, a
memory record and ``Roofline.row()`` with ``model_flops_total`` as the
reference's.  The memory record: ``argument_size_in_bytes``, the bytes of
rank 0's blocks of the arguments (parameters, optimizer state, batch,
cache), exact; ``peak_live_bytes``, those plus the peak of the bytes the
step's ops hold live at once (``roofline.analysis.LiveBytes``, which says
what it counts).  ``long_500k`` is skipped where ``shape_applicable``
says so; any other failure is reported and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.models import model as M
from repro_torch.models.layers.common import MetaGenerator
from repro_torch.roofline.analysis import LiveBytes, analyze
from repro_torch.sharding import rules
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import (
    TrainHparams,
    make_train_state,
    make_train_step,
    shard_batch,
)
from repro_torch.tree import tree_map

ADAFACTOR_THRESHOLD = 1e11  # params above this use factored optimizer state

#: where the rows go by default (``.gitignore`` lists it)
DEFAULT_OUT = "dryrun-out/dryrun.json"


def model_flops_total(cfg, shape, n_active: int) -> float:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n_active * tokens


def fake_mesh(multi_pod: bool):
    """The production mesh over a ``"fake"`` process group of its size in
    this process, as rank 0 (an existing fake group of another size is
    replaced)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != size:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    t0 = time.time()
    mesh = fake_mesh(multi_pod)
    elayout = "tp" if (shape.kind == "decode" and cfg.moe is not None) else "ep"
    with rules.mesh_context(mesh, fsdp=cfg.fsdp, expert_layout=elayout), torch.device("meta"):
        full = M.init_train_params(MetaGenerator(), cfg)
        n_params = M.count_params(full)
        n_active = M.active_params(cfg, full)
        batch = tree_map(torch.clone, shard_batch(M.input_specs(cfg, shape)))
        if shape.kind == "train":
            opt = make_optimizer("adafactor" if n_params > ADAFACTOR_THRESHOLD else "adamw")
            hp = TrainHparams()
            state = make_train_state(full, opt, hp)
            step = make_train_step(cfg, opt, hp)
            args = (state, batch)

            def fn(state, batch):
                return step(state, batch)
        else:
            # each block its own (meta) storage, as a rank would hold it
            serving = M.per_layer(tree_map(torch.clone, rules.params_local(full)), cfg)
            local_b = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]
            if shape.kind == "prefill":
                args = (serving, batch)

                def fn(params, batch):
                    with torch.no_grad():
                        return M.prefill(params, batch, cfg, shape.seq_len)
            else:
                cache = M.init_cache(cfg, local_b, shape.seq_len, "meta")
                cache["cur"] = shape.seq_len - 1
                args = (serving, cache, batch)

                def fn(params, cache, batch):
                    with torch.no_grad():
                        return M.decode_step(params, cache, batch, cfg)
        with LiveBytes(args) as live:
            roof = analyze(fn, *args, n_chips=mesh.size(),
                           model_flops_total=model_flops_total(cfg, shape, n_active))
    seconds = time.time() - t0
    base = live.base
    mem = {"argument_size_in_bytes": base, "peak_live_bytes": live.peak_bytes}
    result = {
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "device": "meta",
        "chips": mesh.size(),
        "n_params": n_params,
        "n_active": n_active,
        "seconds": round(seconds, 1),
        "memory": mem,
        "roofline": roof.row(),
    }
    if verbose:
        print(f"  [ok] {arch} × {shape_name} × {result['mesh']}: params={n_params / 1e9:.1f}B "
              f"args={base / 2**30:.2f}GiB peak={live.peak_bytes / 2**30:.2f}GiB/dev "
              f"flops/dev={roof.flops:.3e} coll={roof.coll_bytes / 2**20:.1f}MiB/dev "
              f"dcn={roof.dcn_bytes / 2**20:.1f}MiB dominant={roof.dominant} ({seconds:.0f}s)",
              flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    n_ok = n_skip = n_fail = 0
    t0 = time.time()
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
                print(f"[dryrun] {key}", flush=True)
                try:
                    r = run_cell(arch, shape, multi)
                except Exception as e:  # a failure here is a bug in the system
                    traceback.print_exc()
                    r = {"status": "failed", "error": f"{type(e).__name__}: {e}"}
                results[key] = r
                if r["status"] == "ok":
                    n_ok += 1
                elif r["status"] == "skipped":
                    n_skip += 1
                    print(f"  [skip] {r['reason']}")
                else:
                    n_fail += 1
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\n[dryrun] ok={n_ok} skipped={n_skip} FAILED={n_fail} in {time.time() - t0:.0f} s "
          f"-> {args.out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
