#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA routing datapath on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels from
``src/repro_torch/kernels/csrc`` at first use.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), the build time, the
   PTX check (the jump step's ``div.rn.f32``) and the SASS size of each
   kernel;
2. every kernel instance (route, ingest, lookup_dyn x binomial, jump)
   against its plain torch version on the card, bit-exact, at 2^20 keys
   over several fleets, and a 4,096-key sample against the scalar oracle;
3. ``BatchRouter`` on the card, both engines, fused and two-pass:
   ``route_keys`` (CUDA tensor and numpy), ``route_ids``, ``route_batch``
   and fleet events, bit-exact with a router running the plain versions
   on the CPU; the kernels' launch counts are set to 0 before and read
   after, and every kernel must have run;
4. each kernel's time at 2^24 keys (CUDA events, median of repeats)
   beside its bound and its plain version's time.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
with no result line; so does a machine with no CUDA device, or a copy of
this file without the rest of the repository.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = "src/repro_torch/kernels/csrc/routing.cu"
#: the TPU kernels replaced: each kind's pallas_call in the JAX package
REPLACES = {
    "route": "src/repro/kernels/fused.py:202",
    "ingest": "src/repro/kernels/fused.py:255",
    "lookup_dyn": "src/repro/kernels/fused.py:295",
}
ENGINES = ("binomial", "jump")
KINDS = ("route", "ingest", "lookup_dyn")
#: H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): HBM3 at
#: 3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores counts an FMA as two,
#: so 33.5e12 32-bit lane instructions/s (132 SMs x 128 lanes x 1.98 GHz).
#: That is also the SM's issue rate — each of its four schedulers issues at
#: most one 32-lane warp instruction per clock — so no instruction mix runs
#: faster.  The integer ALU instructions these kernels mostly run (IADD3,
#: LOP3, SHF, ISETP) issue at half that rate on their own pipe, but the
#: split of the rest (IMAD, FFMA, MUFU, branches, uniform ops) over pipes is
#: not documented, so the bound takes the issue rate: a floor, looser than a
#: per-pipe count would be.
HBM_BYTES_S = 3.35e12
LANE_INSTR_S = 67e12 / 2
#: SASS instructions each key executes, counted by hand along the common
#: path in ``cuobjdump -sass`` of the sm_90a build (CUDA 12.9): ``key``
#: outside the lookup loop (thread prologue — the grid gives each thread
#: one key —, loads, the splitmix64 of ingest, the mask test, the store;
#: less the part of the exiting iteration it skips), ``iter`` per loop
#: iteration, ``fold`` for binomial's block A/C relocation, ``divert`` for
#: a removed bucket and ``deep`` for its second redirect.  The bound
#: multiplies them by this run's per-key trip counts.  ``static`` is the
#: function's whole SASS size in the build the table was counted from:
#: phase 1 fails if the build differs, so an edit of ``routing.cu`` or
#: another compiler forces a recount.
SASS = {
    ("binomial", "route"): dict(static=472, key=68, iter=44, fold=26, divert=31, deep=11),
    ("binomial", "ingest"): dict(static=232, key=90, iter=44, fold=26, divert=31, deep=11),
    ("binomial", "lookup_dyn"): dict(static=312, key=53, iter=44, fold=26, divert=0, deep=0),
    ("jump", "route"): dict(static=640, key=52, iter=32, fold=0, divert=31, deep=11),
    ("jump", "ingest"): dict(static=600, key=74, iter=32, fold=0, divert=31, deep=11),
    ("jump", "lookup_dyn"): dict(static=440, key=37, iter=31, fold=0, divert=0, deep=0),
}
#: each kernel instance's mangled name in the library
FUNCTIONS = {
    (engine, kind): name.format(E=mangled)
    for engine, mangled in (("binomial", "8Binomial"), ("jump", "4Jump"))
    for kind, name in (
        ("route", "_ZN7routing12route_kernelINS_{E}ENS_9KeySourceEEEvT0_PKjiPKiiS7_iPil"),
        ("ingest", "_ZN7routing12route_kernelINS_{E}ENS_8IdSourceEEEvT0_PKjiPKiiS7_iPil"),
        ("lookup_dyn", "_ZN7routing17lookup_dyn_kernelINS_{E}EEEvPKjPKiiPil"),
    )
}
#: bytes each kernel must move per key: keys (or two id halves) in, ids out
BYTES_PER_KEY = {"route": 8, "ingest": 12, "lookup_dyn": 8}

N_CHECK = 1 << 20  # the repo's acceptance batch (benchmarks/bench_router.py)
N_TIME = 1 << 24
N_ORACLE = 4096


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_sizes(lib: Path, nvcc: str) -> dict[str, int]:
    """Static SASS instruction count of each kernel in the library."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    sizes, name = {}, None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            name = s.split(":", 1)[1].strip()
            sizes[name] = 0
        elif name and s.startswith("/*") and "*/" in s and s[2:6].isalnum() and ";" in s:
            sizes[name] += 1
    return sizes


# --- fleets -----------------------------------------------------------------


def make_fleet(engine: str, n: int, capacity: int, n_fail: int, seed: int):
    """(control plane, device FleetState) with ``n_fail`` random slots of
    ``[0, n-1)`` failed."""
    from repro_torch.core.bulk import FleetState
    from repro_torch.core.registry import make_bulk
    from repro_torch.serving.router import SessionRouter

    plane = SessionRouter(n, engine=make_bulk(engine).scalar_engine)
    rng = np.random.default_rng(seed)
    for b in rng.choice(max(n - 1, 1), size=n_fail, replace=False):
        plane.fail(int(b))
    return plane, FleetState.pack(plane.domain, capacity).to("cuda")


def fleets(engine: str):
    return {
        "1000/1024 healthy": make_fleet(engine, 1000, 1024, 0, 1),
        "1000/1024 250 failed": make_fleet(engine, 1000, 1024, 250, 2),
        "40000/65536 25% failed": make_fleet(engine, 40000, 65536, 10000, 3),
        "n=1": make_fleet(engine, 1, 64, 0, 4),
        "n=1023": make_fleet(engine, 1023, 2048, 0, 5),
        "n=1024": make_fleet(engine, 1024, 2048, 0, 6),
        "n=1025 3 failed": make_fleet(engine, 1025, 2048, 3, 7),
    }


def u32_tensor(rng, size):
    return torch.from_numpy(rng.integers(0, 2**32, size=size, dtype=np.uint32).view(np.int32))


def run_kind(kernels, kind, keys, hi, fleet, plain: bool):
    args = (fleet.packed, fleet.table, fleet.state)
    if kind == "route":
        fn = kernels.route_plain if plain else kernels.route
        return fn(keys, *args)
    if kind == "ingest":
        fn = kernels.ingest_plain if plain else kernels.ingest
        return fn(keys, hi, *args)
    fn = kernels.lookup_dyn_plain if plain else kernels.lookup_dyn
    return fn(keys, fleet.state[:1])


def oracle(engine, kind, plane, keys, hi):
    """Scalar answers for a sample of keys (or id halves)."""
    from repro_torch.core import bits
    from repro_torch.core.binomial import binomial_lookup32
    from repro_torch.core.jump import jump_lookup32

    k = keys.cpu().numpy().view(np.uint32).astype(np.uint64)
    if kind == "ingest":
        k = (hi.cpu().numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)) | k
        return [plane.domain.locate(bits.mix64(int(x))) for x in k]
    if kind == "route":
        return [plane.domain.locate(int(x)) for x in k]
    lookup = binomial_lookup32 if engine == "binomial" else jump_lookup32
    n = plane.domain.total_count
    return [lookup(int(x), n, 16) for x in k]


def phase_kernels(max_err: dict) -> None:
    from repro_torch.core.registry import make_bulk

    rng = np.random.default_rng(0)
    keys = u32_tensor(rng, N_CHECK).cuda()
    hi = u32_tensor(rng, N_CHECK).cuda()
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        for label, (plane, fleet) in fleets(engine).items():
            for kind in KINDS:
                got = run_kind(kernels, kind, keys, hi, fleet, plain=False)
                want = run_kind(kernels, kind, keys, hi, fleet, plain=True)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                max_err[engine, kind] = max(max_err.get((engine, kind), 0), err)
                sample = got[:N_ORACLE].cpu().numpy()
                expect = oracle(engine, kind, plane, keys[:N_ORACLE], hi[:N_ORACLE])
                n_ok = int((sample == np.asarray(expect)).sum())
                print(f"phase 2 {kind}[{engine}] fleet {label}: {N_CHECK} keys, "
                      f"max |kernel - plain| = {err}, oracle {n_ok}/{N_ORACLE}")
                if err or n_ok != N_ORACLE:
                    fail(f"{kind}[{engine}] on fleet {label} disagrees")


# --- the main path ----------------------------------------------------------


def phase_router() -> dict:
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.serving.batch_router import BatchRouter

    for eng in BULK_ENGINES.values():
        eng.kernels.reset_launches()
    rng = np.random.default_rng(1)
    keys_np = rng.integers(0, 2**32, size=N_CHECK, dtype=np.uint32)
    keys = torch.from_numpy(keys_np.view(np.int32)).cuda()
    ids = rng.integers(0, 2**64, size=N_CHECK, dtype=np.uint64)
    sessions = [f"user-{i:07d}:{rng.integers(1 << 40):x}" for i in range(65536)]
    for engine in ENGINES:
        for fused in (True, False):
            gpu = BatchRouter(1000, engine=engine, capacity=1024, fused=fused)
            cpu = BatchRouter(1000, engine=engine, capacity=1024, fused=fused, device="cpu")
            tag = f"{engine} {'fused' if fused else 'two-pass'}"

            def same(what, a, b):
                a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
                if a.shape != b.shape or (a != b).any():
                    fail(f"BatchRouter {tag}: {what} differs from the plain-version router")

            out = gpu.route_keys(keys)
            if not (out.is_cuda and out.dtype == torch.int32):
                fail(f"route_keys returned {out.dtype} on {out.device}")
            same("route_keys(cuda tensor)", out, cpu.route_keys(keys_np))
            same("route_keys(numpy)", gpu.route_keys_np(keys_np), out)
            same("route_ids", gpu.route_ids(ids), cpu.route_ids(ids))
            same("route_batch", gpu.route_batch(sessions), cpu.route_batch(sessions))
            events = 0
            plain_lookup = BULK_ENGINES[engine].kernels.lookup_dyn_plain
            for victim in (17, 503, 998):
                before = gpu.route_keys(keys)
                n_total = torch.tensor([gpu.domain.total_count], dtype=torch.int32, device=keys.device)
                # keys already resolved through the table may be re-aimed
                # when a fail swaps table positions; no other key may move
                diverted = before != plain_lookup(keys, n_total, gpu.omega)
                gpu.fail(victim), cpu.fail(victim)
                after = gpu.route_keys(keys)
                moved = before != after
                stray = moved & (before != victim) & ~diverted
                if bool(stray.any()) or bool((after == victim).any()):
                    fail(f"BatchRouter {tag}: fail({victim}) moved keys that were neither "
                         "on the victim nor already diverted")
                same(f"route_keys after fail({victim})", after, cpu.route_keys(keys_np))
                events += 1
            for name, args in (("recover", (503,)), ("scale_up", ()), ("scale_down", ())):
                getattr(gpu, name)(*args), getattr(cpu, name)(*args)
                same(f"route_keys after {name}", gpu.route_keys(keys), cpu.route_keys(keys_np))
                events += 1
            alive = [b for b in range(gpu.domain.total_count - 1) if b not in gpu.domain.removed]
            burst = rng.choice(alive, size=40, replace=False)
            with gpu.coalesced_events(), cpu.coalesced_events():
                for b in burst:
                    gpu.fail(int(b)), cpu.fail(int(b))
                for b in burst[:15]:
                    gpu.recover(int(b)), cpu.recover(int(b))
            events += 55
            same("route_keys after a coalesced burst", gpu.route_keys(keys), cpu.route_keys(keys_np))
            same("route_ids after the burst", gpu.route_ids(ids), cpu.route_ids(ids))
            if (gpu.routing_epoch, gpu.stats.moved_sessions, gpu.stats.events) != (
                    cpu.routing_epoch, cpu.stats.moved_sessions, cpu.stats.events):
                fail(f"BatchRouter {tag}: epoch or session stats differ")
            print(f"phase 3 BatchRouter {tag}: route_keys/route_ids on {N_CHECK} keys, "
                  f"route_batch on {len(sessions)} ids, {events} fleet events, "
                  f"epoch {gpu.routing_epoch}: bit-exact with the plain-version router")
    torch.cuda.synchronize()
    launches = {(e, k): BULK_ENGINES[e].kernels.launches[k] for e in ENGINES for k in KINDS}
    print("phase 3 launches " + json.dumps({f"{k}[{e}]": n for (e, k), n in launches.items()}))
    missing = [f"{k}[{e}]" for (e, k), n in launches.items() if n == 0]
    if missing:
        fail(f"the main path never launched {missing}")
    return launches


# --- times and bounds -------------------------------------------------------


def trip_counts(engine, keys, fleet):
    """Per key: loop iterations, whether the binomial fold ran, and the
    bucket the loop settles on — what this run's data makes each kernel
    thread execute.  The bucket is held against the plain lookup, so the
    trip counts follow the same loop."""
    from repro_torch.core import binomial_torch as bt

    k = bt.u32(keys)
    n = bt.u32(fleet.state[0])
    iters = torch.full_like(k, 16)
    fold = torch.zeros_like(k, dtype=torch.bool)
    done = torch.zeros_like(fold)
    if engine == "binomial":
        E = bt.next_pow2_u32(n)
        M = E >> 1
        hi, kacc = bt.mix32(k), k
        folded = bt.relocate_within_level(hi & ((M - 1) & bt.MASK32), hi)
        bucket = folded
        for i in range(16):
            c = bt.relocate_within_level(hi & ((E - 1) & bt.MASK32), hi)
            stop = ~done & ((c < M) | (c < n))
            iters = torch.where(stop, i + 1, iters)
            fold = fold | (stop & (c < M))
            bucket = torch.where(stop & (c >= M), c, bucket)
            done = done | stop
            kacc = (kacc + bt.GOLDEN32) & bt.MASK32
            hi = bt.mix32(kacc)
        fold = fold | ~done
    else:
        lk, bucket = k, torch.zeros_like(k)
        top = torch.tensor(2.0**31, dtype=torch.float32, device=k.device)
        for i in range(16):
            lk = lk * 2862933555777941757 + 1
            r = bt._shr64(lk, 33) + 1
            fj = (bucket + 1).to(torch.float32) * torch.div(top, r.to(torch.float32))
            stop = ~done & (fj >= n.to(torch.float32))
            iters = torch.where(stop, i + 1, iters)
            bucket = torch.where(~done & ~stop, fj.to(torch.int64), bucket)
            done = done | stop
    return iters, fold, torch.where(n <= 1, 0, bucket)


def time_ms(fn, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_times() -> dict:
    from repro_torch.core import binomial_torch as bt
    from repro_torch.core.registry import make_bulk

    rng = np.random.default_rng(2)
    keys = u32_tensor(rng, N_TIME).cuda()
    hi = u32_tensor(rng, N_TIME).cuda()
    rows = {}
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        plane, fleet = make_fleet(engine, 1000, 1024, 250, 2)
        fleet_bytes = 4 * (fleet.packed.numel() + fleet.table.numel() + fleet.state.numel())
        for kind in KINDS:
            src = bt.mix64_lo32(keys, hi) if kind == "ingest" else keys
            iters, fold, settled = trip_counts(engine, src, fleet)
            routed = run_kind(kernels, "lookup_dyn", src.to(torch.int32), None, fleet, plain=True)
            if not torch.equal(settled, routed.to(torch.int64)):
                fail(f"the trip counts of {kind}[{engine}] follow another loop than the plain lookup")
            b = bt.u32(routed)
            hit = ((bt.u32(fleet.packed)[b >> 5] >> (b & 31)) & 1) != 0
            q = bt.mulhi32(bt.hash_pair(bt.u32(src), b), bt.u32(fleet.state[0]))
            deep = hit & (q >= bt.u32(fleet.state[1]))
            c = SASS[engine, kind]
            ops = (c["key"] * N_TIME + c["iter"] * int(iters.sum()) + c["fold"] * int(fold.sum())
                   + c["divert"] * int(hit.sum()) + c["deep"] * int(deep.sum()))
            nbytes = BYTES_PER_KEY[kind] * N_TIME + (fleet_bytes if kind != "lookup_dyn" else 4)
            t_ops, t_bytes = ops / LANE_INSTR_S * 1e3, nbytes / HBM_BYTES_S * 1e3
            ms = time_ms(lambda: run_kind(kernels, kind, keys, hi, fleet, plain=False), 21)
            plain_ms = time_ms(lambda: run_kind(kernels, kind, keys, hi, fleet, plain=True), 3)
            rows[engine, kind] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
            )
            print(f"phase 4 {kind}[{engine}] {N_TIME} keys, fleet 1000/1024 with 250 failed: "
                  f"{ms:.4f} ms ({N_TIME / ms / 1e6:.3f} Gkeys/s), bound {max(t_ops, t_bytes):.4f} ms "
                  f"(instructions {t_ops:.4f} ms = {ops / N_TIME:.1f}/key, mean trips "
                  f"{float(iters.double().mean()):.3f}; bytes {t_bytes:.4f} ms), "
                  f"plain version {plain_ms:.3f} ms")
            del iters, fold, settled, routed, b, hit, q, deep
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per output, started together
        lib, ptx = pool.submit(build.build), pool.submit(build.ptx)
        lib, ptx = lib.result(), ptx.result()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({lib.name}); ptxas: "
          + " | ".join(line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
                       if "registers" in line))
    text = ptx.read_text()
    if "div.rn.f32" not in text or "div.approx" in text or "div.full" in text:
        fail("the jump step is not compiled to an IEEE round-to-nearest division")
    print(f"phase 1 ptx: div.rn.f32 x{text.count('div.rn.f32')}, no approximate division")
    sizes = sass_sizes(lib, build.nvcc())
    print("phase 1 sass instructions " + json.dumps(
        {f"{k}[{e}]": sizes.get(name) for (e, k), name in FUNCTIONS.items()}))
    stale = [f"{k}[{e}]" for (e, k), name in FUNCTIONS.items()
             if sizes.get(name) != SASS[e, k]["static"]]
    if stale:
        fail(f"the SASS of {stale} differs from the build the SASS table was counted "
             "from: recount the table")
    build.library()

    max_err: dict = {}
    phase_kernels(max_err)
    launches = phase_router()
    rows = phase_times()
    kernels = [
        dict(name=f"{kind}[{engine}]", route="cuda", source=SRC, replaces=REPLACES[kind],
             launches=launches[engine, kind], max_abs_err=max_err[engine, kind],
             bit_exact=max_err[engine, kind] == 0, **rows[engine, kind], library_ms=None)
        for engine in ENGINES for kind in KINDS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
