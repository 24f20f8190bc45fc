"""Replicated placement walkthrough on the PyTorch port: fail -> degraded
read -> repair -> restored replication (DESIGN.md §13).

Run:  PYTHONPATH=src python examples/placement_demo_torch.py              # the CUDA card
      PYTHONPATH=src python examples/placement_demo_torch.py --device cpu

The counterpart of ``examples/placement_demo.py``, line for line: the
router's family route and resolve run as CUDA kernels on the card, their
plain torch versions with ``--device cpu``.

A 3-way replicated store over an 8-shard fleet: every key lives on three
distinct alive shards.  We kill two of one key's three holders, read it
degraded from the survivor, let the budgeted repairer re-materialise the
missing copies, and verify the journal replays to the same placement
bit-exactly.
"""
import argparse

import numpy as np

from repro_torch.device import describe, resolve_device
from repro_torch.placement.store import StorePlacement
from repro_torch.serving.batch_router import BatchRouter
from repro_torch.serving.lifecycle import (
    LifecycleConfig,
    LifecycleManager,
    PlacementRepairer,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    device = resolve_device(ap.parse_args(argv).device)
    print(describe(device))
    router = BatchRouter(8, engine="binomial", device=device)
    mgr = LifecycleManager(router, LifecycleConfig(min_alive_floor=1))
    store = StorePlacement(router, r=3)

    keys = np.random.default_rng(0).integers(
        0, 1 << 32, size=4096, dtype=np.uint32
    )
    batch = store.register(keys)
    print(f"registered {keys.size} keys on {mgr.n_alive} shards, "
          f"mode={batch.mode}, {batch.n_distinct} replicas each")

    repairer = PlacementRepairer(store, mgr, budget_per_tick=256)

    # -- failure: two of key 0's three holders die ---------------------------
    holders = store.holders[0].tolist()
    victims = holders[:2]
    print(f"\nkey 0 holders: {holders}; killing {victims}")
    for s in victims:
        mgr.fail(int(s))

    found, mode = store.read(0)
    print(f"degraded read of key 0: holders={found.tolist()}, mode={mode}")
    counts = store.reachable_counts()
    print(f"fleet-wide reachable replicas: min={counts.min()}, "
          f"mean={counts.mean():.2f} (no key at zero: {bool((counts >= 1).all())})")

    # -- repair: budgeted batches, oldest epoch first ------------------------
    print(f"\nrepair backlog: {repairer.backlog} under-replicated copies")
    ticks = 0
    while repairer.backlog:
        done = repairer.tick()
        ticks += 1
        print(f"  tick {ticks}: copied {len(done)} replicas "
              f"(backlog {repairer.backlog})")
    counts = store.reachable_counts()
    print(f"after repair: every key at {counts.min()}..{counts.max()} "
          f"distinct replicas (target min(r, n_alive) = "
          f"{min(store.r, mgr.n_alive)})")

    # -- recovery: the failed shards return ----------------------------------
    for s in victims:
        if s in router.domain.removed:
            mgr.recover(int(s))
    repairer.quiesce()
    found, mode = store.read(0)
    print(f"\nafter recovery + quiesce: key 0 holders={found.tolist()}, "
          f"mode={mode}")
    print(f"replication restored: "
          f"{bool((store.reachable_counts() == store.r).all())}")

    # -- crash safety: journal replay reproduces the placement ---------------
    repairer.verify_placement_replay()
    print("journal replay reproduces the live placement bit-exactly")


if __name__ == "__main__":
    main()
