"""Quickstart on the PyTorch port: the paper's algorithm in 30 seconds,
host-side and on the device.

    PYTHONPATH=src python examples/quickstart_torch.py              # the CUDA card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The counterpart of ``examples/quickstart.py``, line for line.  Where that
one runs the Pallas kernel in interpret mode, this one runs the static-n
lookup's CUDA kernel on the card and holds it against the plain torch path;
with ``--device cpu`` the kernel does not run, and the output says so.
"""
import argparse
import collections

import numpy as np
import torch

from repro_torch.core import BinomialHash, binomial_lookup_vec
from repro_torch.device import describe, resolve_device
from repro_torch.kernels.ops import binomial_bulk_lookup


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    device = resolve_device(ap.parse_args(argv).device)
    print(describe(device))

    # -- host-side: route 100k data units onto 11 nodes -----------------------
    engine = BinomialHash(n=11)
    keys = [hash(f"object-{i}") & (2**63 - 1) for i in range(100_000)]
    table = {k: engine.get_bucket(k) for k in keys}
    load = collections.Counter(table.values())
    print("load per node   :", [load[i] for i in range(11)])

    # -- scale up: node 11 joins; only ~1/12 of keys move, all onto node 11 ---
    engine.add_bucket()
    moves = {k: engine.get_bucket(k) for k in keys if engine.get_bucket(k) != table[k]}
    print(f"scale 11->12    : moved {len(moves)/len(keys):.4f} (ideal {1/12:.4f}), "
          f"targets={set(moves.values())}")

    # -- scale down: LIFO removal; only node 11's keys move -------------------
    engine.remove_bucket()
    back = {k: engine.get_bucket(k) for k in keys}
    print("scale back 12->11: restored exactly =", back == table)

    # -- on the device: the vectorised u32 path (MoE router datapath) --------
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 2**31, 1 << 16)).to(device)
    experts = binomial_lookup_vec(tokens, 256, omega=16)
    counts = np.bincount(experts.cpu().numpy(), minlength=256)
    print(f"in-graph routing: 64k tokens -> 256 experts, max/mean load "
          f"{counts.max()/counts.mean():.3f}")

    # -- the CUDA kernel (the static-n lookup, lookup_vec) --------------------
    if device.type == "cuda":
        buckets = binomial_bulk_lookup(tokens[:8192], 256, device=device)
        print("cuda kernel     : matches plain path =", torch.equal(buckets, experts[:8192]))
    else:
        print("cuda kernel     : not run (--device cpu); the static-n lookup's kernel runs "
              "only on the card")


if __name__ == "__main__":
    main()
