#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card: the routing
datapath and the hash-routed MoE serving path.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels from
``src/repro_torch/kernels/csrc`` at first use.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), the build time, the
   PTX check (the jump step's ``div.rn.f32``) and the SASS size of each
   kernel;
2. every kernel instance (route, ingest, lookup_dyn, lookup_vec x
   binomial, jump) against its plain torch version on the card,
   bit-exact, at 2^20 keys over several fleets (lookup_vec: over several
   static n), and a 4,096-key sample against the scalar oracle;
3. the two main paths, each with the kernels' launch counts set to 0
   just before it and read just after:
   - ``BatchRouter`` on the card, both engines, fused and two-pass:
     ``route_keys`` (CUDA tensor and numpy), ``route_ids``, ``route_batch``
     and fleet events, bit-exact with a router running the plain versions
     on the CPU; route, ingest and lookup_dyn must have run;
   - ``ServingTier`` serving Qwen3-235B-A22B at its published widths, cut
     to 4 layers, bf16, random weights from a seeded generator, with the
     BinomialHash MoE router: 3 replicas, 24 requests of 8 tokens, 8 new
     tokens each, then replica 1 fails and the batch is served again, per
     engine.  Every request is answered, only the failed replica's
     sessions move, every expert id equals the plain lookup's, and the
     static-n lookup ran layers x (1 + new tokens) times per group
     served; one more call runs under ``torch.profiler`` for the
     device's busy share.  Before it, a reduced float32 model served on
     the card agrees with the same tier on the CPU;
4. each kernel's time at 2^24 keys (CUDA events, median of repeats)
   beside its bound and its plain version's time; the static-n lookup
   also at the serve path's own sizes.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
with no result line; so does a machine with no CUDA device, or a copy of
this file without the rest of the repository.
"""
from __future__ import annotations

import dataclasses
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
    "lookup_vec": "src/repro/kernels/binomial_hash.py:91",
}
ENGINES = ("binomial", "jump")
#: the kernels that read a fleet (the routing datapath), and all kernels
FLEET_KINDS = ("route", "ingest", "lookup_dyn")
KINDS = (*FLEET_KINDS, "lookup_vec")
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
    # the static-n kernel: n, E and M arrive as launch arguments, so the
    # binomial key path drops the n load and the next-pow2 cascade (-14)
    # and the jump key path the n load (-1); the loops are the same
    ("binomial", "lookup_vec"): dict(static=496, key=39, iter=44, fold=26, divert=0, deep=0),
    ("jump", "lookup_vec"): dict(static=440, key=36, iter=31, fold=0, divert=0, deep=0),
}
#: each kernel instance's mangled name in the library
FUNCTIONS = {
    (engine, kind): name.format(E=mangled)
    for engine, mangled in (("binomial", "8Binomial"), ("jump", "4Jump"))
    for kind, name in (
        ("route", "_ZN7routing12route_kernelINS_{E}ENS_9KeySourceEEEvT0_PKjiPKiiS7_iPil"),
        ("ingest", "_ZN7routing12route_kernelINS_{E}ENS_8IdSourceEEEvT0_PKjiPKiiS7_iPil"),
        ("lookup_dyn", "_ZN7routing17lookup_dyn_kernelINS_{E}EEEvPKjPKiiPil"),
        ("lookup_vec", "_ZN7routing17lookup_vec_kernelINS_{E}EEEvPKjjjjiPil"),
    )
}
#: bytes each kernel must move per key: keys (or two id halves) in, ids out
BYTES_PER_KEY = {"route": 8, "ingest": 12, "lookup_dyn": 8, "lookup_vec": 8}

N_CHECK = 1 << 20  # the repo's acceptance batch (benchmarks/bench_router.py)
N_TIME = 1 << 24
N_ORACLE = 4096
#: static n for the lookup_vec checks: the pow2 edges and the paper's
#: cluster sizes (configs.PAPER_BENCH); n = 1000 for its times, as lookup_dyn
VEC_NS = (2, 3, 10, 11, 100, 128, 1000, 1023, 1024, 1025, 10000, 65536, 100000)
VEC_N_TIME = 1000

#: the serve phase: Qwen3-235B-A22B (its published config, in
#: repro_torch.configs) with the hash router, cut from 94 layers to 4; the
#: the defaults of repro_torch.launch.serve for the traffic
SERVE_ARCH = "qwen3-moe-235b-a22b"
SERVE_LAYERS = 4
SERVE_REPLICAS, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 3, 24, 8, 8
SERVE_FAIL = 1
#: a float32 matmul on the card runs in full float32 (no TF32), so the
#: reduced model's logits on the card and on the CPU differ by summation
#: order alone
SMALL_LOGIT_TOL = 1e-4


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
    """One kernel (or its plain version) on the phase's operands; the
    static-n lookup takes n = ``VEC_N_TIME`` in place of the fleet."""
    if kind == "lookup_vec":
        fn = kernels.lookup_vec_plain if plain else kernels.lookup_vec
        return fn(keys, VEC_N_TIME)
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
            for kind in FLEET_KINDS:
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
        phase_lookup_vec(engine, kernels, keys, max_err)


def phase_lookup_vec(engine, kernels, keys, max_err: dict) -> None:
    """The static-n kernel against its plain version (bit-exact) and the
    scalar oracle over ``VEC_NS``; n = 1 gives zeros with no launch."""
    from repro_torch.core.binomial import binomial_lookup32
    from repro_torch.core.jump import jump_lookup32

    oracle32 = binomial_lookup32 if engine == "binomial" else jump_lookup32
    sample = keys[:N_ORACLE].cpu().numpy().view(np.uint32)
    for n in VEC_NS:
        got = kernels.lookup_vec(keys, n)
        want = kernels.lookup_vec_plain(keys, n)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err[engine, "lookup_vec"] = max(max_err.get((engine, "lookup_vec"), 0), err)
        expect = np.asarray([oracle32(int(k), n, 16) for k in sample])
        n_ok = int((got[:N_ORACLE].cpu().numpy() == expect).sum())
        print(f"phase 2 lookup_vec[{engine}] n={n}: {N_CHECK} keys, max |kernel - plain| = "
              f"{err}, oracle {n_ok}/{N_ORACLE}")
        if err or n_ok != N_ORACLE:
            fail(f"lookup_vec[{engine}] at n = {n} disagrees")
    launched = kernels.launches["lookup_vec"]
    zeros = kernels.lookup_vec(keys, 1)
    if zeros.shape != keys.shape or bool(zeros.any()) or kernels.launches["lookup_vec"] != launched:
        fail(f"lookup_vec[{engine}] at n = 1 is not all zeros without a launch")
    print(f"phase 2 lookup_vec[{engine}] n=1: zeros, no launch")


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
    launches = {(e, k): BULK_ENGINES[e].kernels.launches[k] for e in ENGINES for k in FLEET_KINDS}
    print("phase 3 router launches " + json.dumps({f"{k}[{e}]": n for (e, k), n in launches.items()}))
    missing = [f"{k}[{e}]" for (e, k), n in launches.items() if n == 0]
    if missing:
        fail(f"the router path never launched {missing}")
    return launches


# --- the serving path ------------------------------------------------------


class RouteLog:
    """Wraps the MoE router of ``repro_torch.models.layers.moe`` while
    active, keeping each call's layer salt, token ids and expert ids."""

    def __init__(self):
        from repro_torch.models.layers import moe

        self.moe, self.calls = moe, []

    def __enter__(self):
        route = self.route = self.moe.route

        def recording(p, x, token_ids, layer_salt, cfg):
            out = route(p, x, token_ids, layer_salt, cfg)
            self.calls.append((layer_salt, token_ids, out[0]))
            return out

        self.moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def hash_routed(cfg, engine: str):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="hash", router_hash_engine=engine, router_hash_omega=16))


def make_requests(vocab: int, seed: int):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(f"session-{i}", rng.integers(0, vocab, size=SERVE_PROMPT).astype(np.int32),
                    SERVE_NEW) for i in range(SERVE_REQUESTS)]


def check_answers(tag, out, reqs, vocab: int) -> None:
    if sorted(out) != sorted(r.session_id for r in reqs):
        fail(f"{tag}: not every request was answered")
    for r in reqs:
        row = out[r.session_id]
        if row.shape != (r.n_new,) or row.min() < 0 or row.max() >= vocab:
            fail(f"{tag}: {r.session_id} got {row!r}")


def check_small_model() -> None:
    """The reduced hash-routed model served on the card (float32) against
    the same tier on the CPU, which runs the plain versions: the same
    tokens, and prefill logits within ``SMALL_LOGIT_TOL``."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingTier

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    for engine in ENGINES:
        cfg = hash_routed(reduced_config(SERVE_ARCH), engine)
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        reqs = make_requests(cfg.vocab_size, 7)
        tiers = [ServingTier(cfg, p, SERVE_REPLICAS, max_len=SERVE_PROMPT + SERVE_NEW + 2,
                             engine=engine, device=d)
                 for p, d in ((M.params_to(params, "cuda"), "cuda"), (params, "cpu"))]
        outs = [t.serve(reqs) for t in tiers]
        check_answers(f"reduced serve[{engine}]", outs[0], reqs, cfg.padded_vocab)
        same = all(np.array_equal(outs[0][r.session_id], outs[1][r.session_id]) for r in reqs)
        prompts = torch.from_numpy(np.stack([r.prompt for r in reqs]))
        logits = [M.prefill(t.replicas[0].params, {"tokens": prompts.to(t.device)}, cfg, 18)[1].cpu()
                  for t in tiers]
        err = float((logits[0] - logits[1]).abs().max())
        print(f"phase 3 reduced serve[{engine}] ({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"float32): card vs CPU tokens {'identical' if same else 'DIFFER'}, "
              f"max |logit diff| {err:.3g} (tolerance {SMALL_LOGIT_TOL})")
        if not same or not err <= SMALL_LOGIT_TOL:
            fail(f"the reduced serve[{engine}] on the card disagrees with the CPU")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def profile_serve(engine, tier, reqs, n_steps: int, step_floor_ms: float, card: str) -> None:
    """One more serve() call of the same batch under ``torch.profiler``:
    the device's busy share of the wall time and the kernels that take it
    (the profiler's own overhead included in the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tier.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"phase 3 serve[{engine}] profiled serve() call: the profiler recorded no "
              f"device time (wall {wall_ms:.1f} ms)")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"phase 3 serve[{engine}] profiled serve() call: wall {wall_ms:.1f} ms for {n_steps} "
          f"steps, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}; floor "
          f"{n_steps * step_floor_ms:.1f} ms) on {card}; top kernels by device time: "
          + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                      for e in top))


def phase_serve(card: str) -> tuple[dict, dict]:
    """ServingTier at full width: -> (launches, the router keys each
    lookup_vec launch took, by phase and engine)."""
    from repro_torch.configs import get_config
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.models import model as M
    from repro_torch.models.layers.moe import router_keys
    from repro_torch.serving.engine import ServingTier

    check_small_model()
    base = dataclasses.replace(get_config(SERVE_ARCH), num_layers=SERVE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator("cuda").manual_seed(0), hash_routed(base, "binomial"))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    held = tree_bytes(params)
    # a step (prefill or decode) reads each layer's weights, the final norm
    # and the unembedding once; the expert products run over all experts
    step_floor_ms = (held - tree_bytes(params["embed"]["embedding"])) / HBM_BYTES_S * 1e3
    print(f"phase 3 serve model: {SERVE_ARCH} at its published widths (d_model {base.d_model}, "
          f"{base.num_heads}/{base.num_kv_heads} heads of {base.resolved_head_dim}, "
          f"{base.moe.num_experts} experts top-{base.moe.top_k} of width {base.moe.d_ff_expert}, "
          f"vocab {base.vocab_size} padded to {base.padded_vocab}), {base.dtype}, layers cut "
          f"94 -> {SERVE_LAYERS}; random weights in {init_s:.2f} s; parameters {held / 1e9:.3f} GB "
          f"(reckoned: 4 x 4.975 GB per layer + 2.491 GB embeddings = 22.39 GB)")
    launches, keys_seen = {}, {"prefill": {}, "decode": {}}
    for engine in ENGINES:
        cfg = hash_routed(base, engine)
        kernels = BULK_ENGINES[engine].kernels
        tier = ServingTier(cfg, params, SERVE_REPLICAS, max_len=SERVE_PROMPT + SERVE_NEW + 2,
                           engine=engine)
        reqs = make_requests(cfg.vocab_size, 11)
        ids = [r.session_id for r in reqs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for eng in BULK_ENGINES.values():
            eng.kernels.reset_launches()
        walls, steps, groups = [], [], 0
        with RouteLog() as log:
            for failed in (None, SERVE_FAIL):
                if failed is not None:
                    before = [tier.router.route(i) for i in ids]
                    tier.fail(failed)
                served = len({tier.router.route(i) for i in ids})
                groups += served
                steps.append(served * (1 + SERVE_NEW))
                t0 = time.perf_counter()
                out = tier.serve(reqs)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                check_answers(f"serve[{engine}]", out, reqs, cfg.padded_vocab)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches[engine] = {k: kernels.launches[k] for k in ("route", "lookup_vec")}
        after = [tier.router.route(i) for i in ids]
        moved = [i for i, a, b in zip(ids, before, after) if a != b]
        if any(b != SERVE_FAIL for i, a, b in zip(ids, after, before) if a != b) \
                or SERVE_FAIL in after:
            fail(f"serve[{engine}]: sessions moved that were not on replica {SERVE_FAIL}")
        want = SERVE_LAYERS * (1 + SERVE_NEW) * groups
        if launches[engine]["lookup_vec"] != want or launches[engine]["route"] != 2:
            fail(f"serve[{engine}]: launches {launches[engine]}, expected lookup_vec = "
                 f"{SERVE_LAYERS} layers x (1 + {SERVE_NEW}) x {groups} groups = {want}, route = 2")
        if len(log.calls) != want:
            fail(f"serve[{engine}]: {len(log.calls)} router calls for {want} launches")
        m = cfg.moe
        for salt, tokens, expert_ids in log.calls:
            keys = router_keys(tokens, salt, m.top_k)
            plain = kernels.lookup_vec_plain(keys, m.num_experts, m.router_hash_omega)
            if not torch.equal(expert_ids, plain):
                fail(f"serve[{engine}]: the expert ids of layer {salt} differ from the plain lookup's")
            phase = "prefill" if tokens.shape[1] > 1 else "decode"
            if keys.numel() > keys_seen[phase].get(engine, torch.empty(0)).numel():
                keys_seen[phase][engine] = keys.to(torch.int32)
        tokens_out = SERVE_REQUESTS * SERVE_NEW
        print(f"phase 3 serve[{engine}]: {SERVE_REQUESTS} requests x {SERVE_NEW} new tokens on "
              f"{SERVE_REPLICAS} replicas, all answered; fail({SERVE_FAIL}) moved "
              f"{len(moved)}/{len(ids)} sessions, all from replica {SERVE_FAIL}; "
              f"{len(log.calls)} router calls, every expert id equal to the plain lookup's")
        print(f"phase 3 serve[{engine}] launches " + json.dumps(
            {f"{k}[{engine}]": n for k, n in launches[engine].items()})
            + f" (lookup_vec = {SERVE_LAYERS} x (1 + {SERVE_NEW}) x {groups} groups)")
        print(f"phase 3 serve[{engine}] wall per serve() call: "
              + ", ".join(f"{w * 1e3:.1f} ms ({tokens_out / w:.1f} new tokens/s; {n} model steps, "
                          f"{w * 1e3 / n:.2f} ms per step)" for w, n in zip(walls, steps))
              + f" [first call, then after the failure]; floor per step {step_floor_ms:.2f} ms "
              f"(every weight but the embedding table read once at {HBM_BYTES_S / 1e12} TB/s); "
              f"peak memory {peak / 1e9:.3f} GB (parameters {held / 1e9:.3f} GB; init peak "
              f"{init_peak / 1e9:.3f} GB) on {card}")
        profile_serve(engine, tier, reqs, steps[-1], step_floor_ms, card)
    probe = make_requests(base.vocab_size, 12)[:2]
    prompts = torch.from_numpy(np.stack([r.prompt for r in probe])).cuda()
    _, logits = M.prefill(params, {"tokens": prompts}, hash_routed(base, "binomial"), 18)
    if logits.shape != (2, base.padded_vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"full-width prefill logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    del params, logits
    torch.cuda.empty_cache()
    return launches, keys_seen


# --- times and bounds -------------------------------------------------------


def trip_counts(engine, keys, n):
    """Per key: loop iterations, whether the binomial fold ran, and the
    bucket the loop settles on — what this run's data makes each kernel
    thread execute, for ``n`` buckets.  The bucket is held against the
    plain lookup, so the trip counts follow the same loop."""
    from repro_torch.core import binomial_torch as bt

    k = bt.u32(keys)
    n = bt.u32(n)
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


def bound(engine, kind, keys, fleet, n_vec: int = VEC_N_TIME) -> dict:
    """The least time the card could take for ``kind`` on these keys: the
    larger of the SASS lane instructions this data makes the kernel run
    (at the issue rate) and the bytes it must move (at the HBM rate).  The
    static-n lookup takes ``n_vec`` as a launch argument and reads no
    fleet."""
    from repro_torch.core import binomial_torch as bt
    from repro_torch.core.registry import make_bulk

    kernels = make_bulk(engine).kernels
    count = keys.numel()
    n = fleet.state[0] if kind != "lookup_vec" else torch.tensor(n_vec, device=keys.device)
    iters, fold, settled = trip_counts(engine, keys, n)
    if kind == "lookup_vec":
        routed = kernels.lookup_vec_plain(keys, n_vec)
    else:
        routed = kernels.lookup_dyn_plain(keys.to(torch.int32), fleet.state[:1])
    if not torch.equal(settled, routed.to(torch.int64)):
        fail(f"the trip counts of {kind}[{engine}] follow another loop than the plain lookup")
    c = SASS[engine, kind]
    ops = c["key"] * count + c["iter"] * int(iters.sum()) + c["fold"] * int(fold.sum())
    nbytes = BYTES_PER_KEY[kind] * count
    if kind in ("route", "ingest"):
        b = bt.u32(routed)
        hit = ((bt.u32(fleet.packed)[b >> 5] >> (b & 31)) & 1) != 0
        q = bt.mulhi32(bt.hash_pair(bt.u32(keys), b), bt.u32(fleet.state[0]))
        deep = hit & (q >= bt.u32(fleet.state[1]))
        ops += c["divert"] * int(hit.sum()) + c["deep"] * int(deep.sum())
        nbytes += 4 * (fleet.packed.numel() + fleet.table.numel() + fleet.state.numel())
    elif kind == "lookup_dyn":
        nbytes += 4  # n
    t_ops, t_bytes = ops / LANE_INSTR_S * 1e3, nbytes / HBM_BYTES_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                t_ops=t_ops, t_bytes=t_bytes, per_key=ops / count,
                trips=float(iters.double().mean()))


def phase_times(serve_keys: dict, n_experts: int) -> dict:
    from repro_torch.core import binomial_torch as bt
    from repro_torch.core.registry import make_bulk

    rng = np.random.default_rng(2)
    keys = u32_tensor(rng, N_TIME).cuda()
    hi = u32_tensor(rng, N_TIME).cuda()
    rows = {}
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        plane, fleet = make_fleet(engine, 1000, 1024, 250, 2)
        for kind in KINDS:
            src = bt.mix64_lo32(keys, hi) if kind == "ingest" else keys
            b = bound(engine, kind, src, fleet)
            ms = time_ms(lambda: run_kind(kernels, kind, keys, hi, fleet, plain=False), 21)
            plain_ms = time_ms(lambda: run_kind(kernels, kind, keys, hi, fleet, plain=True), 3)
            rows[engine, kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                                      bound_by=b["bound_by"])
            what = "n = 1000" if kind == "lookup_vec" else "fleet 1000/1024 with 250 failed"
            print(f"phase 4 {kind}[{engine}] {N_TIME} keys, {what}: "
                  f"{ms:.4f} ms ({N_TIME / ms / 1e6:.3f} Gkeys/s), bound {b['bound_ms']:.4f} ms "
                  f"(instructions {b['t_ops']:.4f} ms = {b['per_key']:.1f}/key, mean trips "
                  f"{b['trips']:.3f}; bytes {b['t_bytes']:.4f} ms), "
                  f"plain version {plain_ms:.3f} ms")
        for phase, by_engine in serve_keys.items():
            # the router's own keys at the serve path's largest group
            vk = by_engine[engine]
            b = bound(engine, "lookup_vec", vk, None, n_experts)
            ms = time_ms(lambda: kernels.lookup_vec(vk, n_experts), 101)
            plain_ms = time_ms(lambda: kernels.lookup_vec_plain(vk, n_experts), 11)
            rows[engine, "lookup_vec"].update({
                f"{phase}_keys": vk.numel(), f"{phase}_ms": ms, f"{phase}_plain_ms": plain_ms,
                f"{phase}_bound_ms": b["bound_ms"]})
            print(f"phase 4 lookup_vec[{engine}] at the serve path's {phase} size, "
                  f"{vk.numel()} router keys, n = {n_experts}: {ms:.4f} ms per launch, bound "
                  f"{b['bound_ms']:.6f} ms ({b['bound_by']}), plain version {plain_ms:.3f} ms")
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
    by_path = {"router": phase_router()}
    serve_launches, serve_keys = phase_serve(card)
    by_path["serve"] = {(e, k): n for e, counts in serve_launches.items() for k, n in counts.items()}
    from repro_torch.configs import get_config

    rows = phase_times(serve_keys, get_config(SERVE_ARCH).moe.num_experts)
    kernels = []
    for engine in ENGINES:
        for kind in KINDS:
            paths = {p: c[engine, kind] for p, c in by_path.items() if (engine, kind) in c}
            kernels.append(dict(
                name=f"{kind}[{engine}]", route="cuda", source=SRC, replaces=REPLACES[kind],
                launches=sum(paths.values()), launches_by_path=paths,
                max_abs_err=max_err[engine, kind], bit_exact=max_err[engine, kind] == 0,
                **rows[engine, kind], library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
