"""Observability tier walkthrough on the PyTorch port: metrics, spans,
device load counts, theory-bound alarms, and the two export formats
(DESIGN.md §15).

Run:  PYTHONPATH=src python examples/observability_demo_torch.py              # the CUDA card
      PYTHONPATH=src python examples/observability_demo_torch.py --device cpu

The counterpart of ``examples/observability_demo.py``, line for line: the
instrumented route (``route_load``) runs as a CUDA kernel on the card, its
plain torch version with ``--device cpu``.

Four acts, all on ONE virtual µs timeline so every number reproduces:

1. a streaming front end serves traffic with the telemetry plane wired
   through admit -> batch close -> dispatch -> read -> complete;
2. a bulk router with a ``LoadMonitor`` attached routes exact and
   stride-sampled batches through the instrumented fused dispatch, then
   drains the device accumulator and compares peak/mean against the
   balls-into-bins envelope;
3. the theory-bound alarms fire on demand: a seeded pathological remap
   breaks the delta/n disruption bound, a rigged skew breaks the balance
   envelope — both delivered as typed alarm objects, not log lines;
4. the whole plane exports as a Prometheus exposition and a JSON
   snapshot.
"""
import argparse
import json

import numpy as np

from repro_torch.device import describe, resolve_device
from repro_torch.observability import (
    LoadConfig,
    LoadMonitor,
    MetricsRegistry,
    SpanTrace,
    disruption_bound,
    expected_peak_over_mean,
    to_json,
    to_prometheus,
)
from repro_torch.serving.batch_router import BatchRouter
from repro_torch.serving.lifecycle import AdmissionRejectedError, LifecycleManager
from repro_torch.serving.streaming import (
    StreamConfig,
    StreamingFrontEnd,
    StreamRequest,
    VirtualClockUs,
)

N_SHARDS = 8
N_BULK_SHARDS = 32


def act_1_streaming(clock, metrics, trace, device):
    print("act 1: streaming front end with the telemetry plane attached")
    router = BatchRouter(N_SHARDS, engine="binomial", device=device)
    mgr = LifecycleManager(router, clock=clock.seconds_view())
    fe = StreamingFrontEnd(
        mgr,
        config=StreamConfig(max_batch=16, max_wait_us=1_000,
                            service_bound_us=1_000),
        clock=clock,
        service_model=lambda n: 800,
        metrics=metrics,
        tracer=trace,
    )
    rng = np.random.default_rng(42)
    served, shed = 0, 0
    for i in range(120):
        clock.advance_us(60 if i < 60 else 15)  # ramp up the arrival rate
        served += len(fe.pump())
        req = StreamRequest(
            key=int(rng.integers(0, 1 << 32)),
            deadline_us=clock.now_us() + 4_000,
            tenant=f"tenant-{i % 3}",
        )
        try:
            fe.submit(req)
        except AdmissionRejectedError:
            shed += 1
    for _ in range(8):
        clock.advance_us(1_000)
        served += len(fe.pump())
    served += len(fe.drain())
    lat = metrics.family("stream_request_latency_us")
    total_lat = sum(h.count for h in lat.values())
    print(f"  served {served}, shed {shed}; latency histogram holds "
          f"{total_lat} samples across {len(lat)} tenants")
    for name in ("admit", "batch_close", "dispatch", "request"):
        print(f"  spans[{name:>11}] = {trace.count(name)}")


def act_2_load_monitor(metrics, device):
    print("\nact 2: device-side load accumulator on the bulk router")
    router = BatchRouter(N_BULK_SHARDS, engine="binomial", device=device)
    alarms = []
    mon = LoadMonitor(
        router,
        metrics=metrics,
        # sample batches past 16k keys at 1/2^4 — small numbers so the
        # demo stays quick; production defaults are 32k and 1/64
        config=LoadConfig(drain_every=1 << 30, exact_cutoff=1 << 14,
                          sample_shift=4),
        on_alarm=alarms.append,
    )
    rng = np.random.default_rng(7)
    router.route_keys(rng.integers(0, 1 << 32, 4_096, np.uint32))   # exact
    router.route_keys(rng.integers(0, 1 << 32, 1 << 16, np.uint32))  # sampled
    window = mon.drain()
    ratio = mon.peak_over_mean()
    envelope = expected_peak_over_mean(mon.total_keys, N_BULK_SHARDS)
    print(f"  drained {int(window.sum())} key-units over {N_BULK_SHARDS} "
          f"shards (one exact batch, one 1/16-sampled batch)")
    print(f"  peak/mean {ratio:.3f} vs balls-into-bins envelope "
          f"{envelope:.3f} (alarm threshold {2.0 * envelope:.3f})")
    assert not alarms, "uniform traffic must not alarm"
    return router, mon, alarms


def act_3_alarms(router, mon, alarms):
    print("\nact 3: both theory-bound alarms, fired on demand")
    # disruption: score a rigged remap where EVERY probe moved after one
    # membership event — far past the delta/n bound
    probes = np.zeros(256, np.int32)
    moved = mon.tracker.observe(probes, probes + 1, delta_events=1,
                                n_before=16, n_after=16, epoch=99)
    bound = disruption_bound(1, 16, 16, slack=mon.config.disruption_slack)
    a = alarms[-1]
    print(f"  pathological remap: moved {moved:.2f} > bound {bound:.3f} "
          f"-> {type(a).__name__}")
    # balance: rig the host totals so one shard holds half the keys
    mon.totals[:] = 0
    mon.totals[0] = 50_000
    mon.totals[1:] = 50_000 // (N_BULK_SHARDS - 1)
    ratio = mon.peak_over_mean()
    mon._check_balance(ratio, mon._alive_slots())
    a = alarms[-1]
    print(f"  rigged skew: peak/mean {ratio:.1f} -> {type(a).__name__}")
    print(f"  ({a})")


def act_4_export(metrics, trace, mon):
    print("\nact 4: exports")
    prom = to_prometheus(metrics)
    lines = prom.splitlines()
    print(f"  Prometheus exposition: {len(lines)} lines; first five:")
    for line in lines[:5]:
        print(f"    {line}")
    snap = json.loads(to_json(metrics, trace=trace, monitor=mon))
    print(f"  JSON snapshot sections: {sorted(snap)}; "
          f"{len(snap['metrics'])} metric families")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    device = resolve_device(ap.parse_args(argv).device)
    print(describe(device))
    clock = VirtualClockUs()
    metrics = MetricsRegistry(clock=clock)
    trace = SpanTrace(capacity=1 << 12)
    act_1_streaming(clock, metrics, trace, device)
    router, mon, alarms = act_2_load_monitor(metrics, device)
    act_3_alarms(router, mon, alarms)
    act_4_export(metrics, trace, mon)


if __name__ == "__main__":
    main()
