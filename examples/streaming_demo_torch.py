"""Streaming front-end walkthrough on the PyTorch port: ramp -> shed ->
flap -> hedge -> fail -> repair-through-serve -> recovery (DESIGN.md §14).

Run:  PYTHONPATH=src python examples/streaming_demo_torch.py              # the CUDA card
      PYTHONPATH=src python examples/streaming_demo_torch.py --device cpu

The counterpart of ``examples/streaming_demo.py``, line for line: every
closed micro-batch routes through the card's kernels, or their plain torch
versions with ``--device cpu``.

Everything runs on ONE virtual µs timeline (`VirtualClockUs` +
`seconds_view()` for the failure detector), so the walkthrough is
deterministic: the same sheds, the same breaker trip, the same repair
arc every run — while every closed micro-batch still routes through the
real fused device dispatch.
"""
import argparse

import numpy as np

from repro_torch.device import describe, resolve_device
from repro_torch.placement.store import StorePlacement
from repro_torch.serving.batch_router import BatchRouter
from repro_torch.serving.lifecycle import (
    AdmissionRejectedError,
    LifecycleManager,
    PlacementRepairer,
)
from repro_torch.serving.streaming import (
    StreamConfig,
    StreamingFrontEnd,
    StreamRequest,
    VirtualClockUs,
)

N_SHARDS = 8
MAX_BATCH = 16
SERVICE_US = 800       # simulated per-dispatch service time
BOUND_US = 1_000       # declared SLO bound (capacity = 16k req/s)
SLO_US = 4_000


def offer(fe, clock, n, gap_us, tag):
    """Open-loop arrivals: submit n requests one gap apart, pumping the
    batcher as virtual time advances; report served/shed."""
    served, shed = [], 0
    rng = np.random.default_rng(hash(tag) % (1 << 32))
    for _ in range(n):
        clock.advance_us(gap_us)
        served.extend(fe.pump())
        req = StreamRequest(
            key=int(rng.integers(0, 1 << 32)),
            deadline_us=clock.now_us() + SLO_US,
            tenant=f"tenant-{int(rng.integers(0, 4))}",
        )
        try:
            fe.submit(req)
        except AdmissionRejectedError:
            shed += 1
    for _ in range(8):
        clock.advance_us(BOUND_US)
        served.extend(fe.pump())
    served.extend(fe.drain())
    miss = max((r.deadline_miss_us for r in served), default=0)
    print(f"  {tag}: offered {n}, served {len(served)}, "
          f"shed-at-admission {shed}, worst deadline overshoot {miss}us "
          f"(one batch window = {fe.config.max_wait_us}us)")
    return served


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    device = resolve_device(ap.parse_args(argv).device)
    print(describe(device))
    router = BatchRouter(N_SHARDS, engine="binomial", device=device)
    clock = VirtualClockUs()
    mgr = LifecycleManager(router, clock=clock.seconds_view())
    store = StorePlacement(router, r=3)
    store.register(
        np.random.default_rng(0).integers(0, 1 << 32, 1024, np.uint32)
    )
    repairer = PlacementRepairer(store, mgr, budget_per_tick=256)
    victim = 2  # the shard phase 3 will flap and phase 4 will kill

    def victim_suspect_probe(shard):
        # simulated transport: the flapping shard answers slowly
        return 900 if shard == victim else 120

    fe = StreamingFrontEnd(
        mgr,
        store=store,
        config=StreamConfig(
            max_batch=MAX_BATCH,
            max_wait_us=1_000,
            service_bound_us=BOUND_US,
            hedge_after_us=300,
        ),
        clock=clock,
        service_model=lambda n: SERVICE_US,
        probe=victim_suspect_probe,
    )

    # -- phase 1: half capacity — nothing sheds ------------------------------
    print("phase 1: offered load at 0.5x declared capacity")
    offer(fe, clock, 200, gap_us=125, tag="steady")

    # -- phase 2: 3x capacity — admission sheds, served stay in bound --------
    print("\nphase 2: offered load at 3x declared capacity")
    offer(fe, clock, 600, gap_us=21, tag="overload")
    print(f"  typed shed reasons: {dict(fe.admission.shed_by_reason)}")

    # -- phase 3: a flapping shard trips its breaker -------------------------
    det = mgr.detector
    for s in det.slots:
        det.heartbeat(s)
    print(f"\nphase 3: shard {victim} flaps (3x silent past suspect_after, "
          "returning before fail_after each time)")
    primaries = np.asarray(store.holders)[:, 0]
    key_idx = int(np.nonzero(primaries == victim)[0][0])
    for flap in range(3):
        for _ in range(7):  # 3.5s of silence: suspect, not yet failed
            clock.advance_us(500_000)
            for s in det.slots:
                if s != victim:
                    det.heartbeat(s)
            mgr.tick()
            fe.pump()
        if flap == 0:
            # suspect primary, breaker still closed: the hedge fires
            r = fe.read(key_idx)
            print(f"  suspect primary, breaker closed — read key {key_idx}: "
                  f"won by shard {r.shard}, hedged={r.hedged}, "
                  f"latency {r.latency_us}us, holders {list(r.holders)}")
        det.heartbeat(victim)  # back just under the fail_after wire
        mgr.tick()
        fe.pump()
    print(f"  breaker trips: {fe.breakers.trips}, "
          f"open: {list(fe.breakers.open_slots)} "
          f"(no formal membership event: epoch still {mgr.epoch})")

    # -- with the breaker open the primary is re-elected outright ------------
    r = fe.read(key_idx)
    print(f"  breaker open — read key {key_idx} (flapping primary {victim}): "
          f"won by shard {r.shard}, hedged={r.hedged}, "
          f"latency {r.latency_us}us, holders {list(r.holders)}")

    # -- phase 4: formal failure; serve traffic IS the repair cadence --------
    print(f"\nphase 4: shard {victim} formally fails")
    mgr.fail(victim)
    print(f"  repair backlog: {repairer.backlog} under-replicated copies")
    rounds = 0
    while repairer.backlog and rounds < 20:
        offer_n = MAX_BATCH
        rounds += 1
        offer(fe, clock, offer_n, gap_us=125, tag=f"serve round {rounds}")
    counts = store.reachable_counts()
    print(f"  backlog drained by serve dispatches alone: "
          f"{repairer.backlog == 0}; replicas now "
          f"{counts.min()}..{counts.max()}")

    # -- recovery + replay parity --------------------------------------------
    mgr.recover(victim)
    repairer.quiesce()
    mgr.verify_replay()
    repairer.verify_placement_replay()
    print(f"\nrecovered shard {victim}; journal and placement replay "
          f"bit-exactly; final stats: {fe.stats()}")


if __name__ == "__main__":
    main()
