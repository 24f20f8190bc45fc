"""Training launcher, on the CUDA device unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --preset smoke --steps 20 [--device cpu]

Presets:
  smoke  — the reduced config, a tiny batch
  100m   — a ~100M-parameter config of the same family
  full   — the published config

Wires the whole path as the JAX package's ``repro.launch.train`` does: the
BinomialHash-sharded data pipeline (``--hosts`` simulated data hosts, their
batches concatenated), AdamW or Adafactor with warmup-cosine, remat,
gradient accumulation and compression, and checkpoints placed on storage
nodes by BinomialHash, resumed from the latest step in ``--ckpt-dir``.
Parameters are random, from a generator seeded with 0 on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import apply_overrides, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, ShardedDataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import TrainHparams, make_train_state, make_train_step


def preset_config(arch: str, preset: str):
    if preset == "full":
        return get_config(arch)
    if preset == "smoke":
        return reduced_config(arch)
    if preset == "100m":
        cfg = get_config(arch)
        kw = dict(
            num_layers=max(len(cfg.pattern) * 2, 4),
            d_model=768,
            d_ff=2048,
            vocab_size=32000,
            dtype="float32",
            param_dtype="float32",
            remat="none",
            fsdp=False,
        )
        if cfg.attention != "none":
            kw.update(num_heads=12, num_kv_heads=max(1, min(cfg.num_kv_heads, 4)), head_dim=64)
        if cfg.moe is not None:
            kw.update(moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=2, d_ff_expert=512),
                      moe_layer_start=1, num_layers=4)
        if cfg.mla is not None:
            kw.update(mla=dataclasses.replace(cfg.mla, q_lora_rank=256, kv_lora_rank=128,
                                              qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64))
        if cfg.ssm is not None:
            kw.update(ssm=dataclasses.replace(cfg.ssm, chunk=64))
        if cfg.rglru is not None:
            kw.update(rglru=dataclasses.replace(cfg.rglru, lru_width=768))
        if cfg.window is not None:
            kw.update(window=256)
        if cfg.mrope_sections:
            kw.update(mrope_sections=(16, 8, 8))
        return dataclasses.replace(cfg, **kw)
    raise KeyError(preset)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compression", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--hosts", type=int, default=1, help="simulated data hosts")
    ap.add_argument("--override", action="append", default=[], help="cfg key=value")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    cfg = apply_overrides(preset_config(args.arch, args.preset), args.override)
    if cfg.input_mode != "tokens":
        ap.error(f"{args.arch} takes {cfg.input_mode} inputs; the train launcher takes token archs")
    device = resolve_device(args.device)

    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch, num_shards=max(64, 4 * args.hosts))
    hosts = [ShardedDataPipeline(dcfg, args.hosts, h) for h in range(args.hosts)]

    def global_batch(step):
        parts = [h.batch(step) for h in hosts]
        return {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(device)
                for k in ("tokens", "targets")}

    opt = make_optimizer(args.optimizer, lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                         total=args.steps)
    hp = TrainHparams(grad_accum=args.grad_accum, compression=args.compression)
    params = M.init_train_params(torch.Generator(device).manual_seed(0), cfg)
    print(f"[train] {cfg.name} preset={args.preset} params={M.count_params(params)/1e6:.1f}M "
          f"device={device}")
    state = make_train_state(params, opt, hp)
    step_fn = make_train_step(cfg, opt, hp)
    mgr = CheckpointManager(args.ckpt_dir, n_nodes=4)

    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        print(f"[train] resuming from checkpoint step {latest}")
        state = mgr.restore(latest, state)
        start = latest

    t0 = time.time()
    pending = []
    for step in range(start, args.steps):
        state, metrics = step_fn(state, global_batch(step))
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tps = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(
                f"  step {step:5d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} tok/s={tps:,.0f}"
            )
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            pending.append(mgr.save_async(step, state))
    for t in pending:
        t.join()
    mgr.save(args.steps, state)
    print(f"[train] done in {time.time()-t0:.1f}s; checkpoint at {args.ckpt_dir}")


if __name__ == "__main__":
    main()
