"""Serving launcher: a replica tier fronted by the BinomialHash session router,
on the CUDA device unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
        --replicas 3 --requests 24 --fail-replica 1 [--device cpu]

The model is the architecture's ``reduced_config``, with random parameters
drawn from a generator seeded with 0.  Every token-input architecture
serves: the GQA and MLA transformers (full or sliding-window attention,
dense or MoE), RecurrentGemma (RG-LRU) and Mamba2 (SSD).  The embeds-input
backbones (musicgen-medium, qwen2-vl-7b) take embeddings, not prompts of
token ids; they run through ``repro_torch.models.model``'s ``prefill`` and
``decode_step`` with an ``embeds`` batch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingTier


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--fail-replica", type=int, default=-1)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch)
    if cfg.input_mode != "tokens":
        ap.error(f"{args.arch} takes {cfg.input_mode} inputs; the serving tier serves token prompts")
    device = resolve_device(args.device)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg)
    tier = ServingTier(
        cfg, params, args.replicas, max_len=args.prompt_len + args.new_tokens + 2, device=device
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            f"session-{i}",
            rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
            n_new=args.new_tokens,
        )
        for i in range(args.requests)
    ]

    t0 = time.time()
    out = tier.serve(reqs)
    print(f"[serve] {len(out)} requests on {args.replicas} replicas ({device}) in {time.time()-t0:.1f}s")
    routes = {r.session_id: tier.router.route(r.session_id) for r in reqs}
    load = np.bincount(list(routes.values()), minlength=args.replicas)
    print(f"[serve] replica load: {load.tolist()} (balance via BinomialHash)")

    if args.fail_replica >= 0:
        tier.fail(args.fail_replica)
        moved = sum(1 for r in reqs if tier.router.route(r.session_id) != routes[r.session_id])
        out2 = tier.serve(reqs)
        print(
            f"[serve] replica {args.fail_replica} failed: {moved}/{len(reqs)} sessions moved "
            f"(only the victims), {len(out2)} requests still served"
        )


if __name__ == "__main__":
    main()
