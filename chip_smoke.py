#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card: the routing
datapath and its chain-mode two-pass path, the hash-routed MoE serving
path (Qwen3-235B-A22B and DeepSeek-V3), the other LM families at full
width and depth (RecurrentGemma-9B, Mamba2-1.3B, Starcoder2-7B,
MusicGen-medium, Qwen2-VL-7B), training (Qwen3-235B-A22B at full width,
one layer, also under a mesh with ZeRO-1), the R-way replicated placement
tier with its fleet lifecycle, and the streaming front end with its live
load telemetry.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels from
``src/repro_torch/kernels/csrc`` at first use.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), the build time and each
   kernel's registers (``-Xptxas -v``; the routing library and the
   training kernels' library, ``csrc/train.cu``, built in parallel), the PTX check (the jump step's
   ``div.rn.f32``) and the SASS size of each kernel;
   "certify": the constant-time certifier (``repro_torch.analysis``) on
   CUDA for both engines: every graph target at the contract's shapes
   (the ``/cuda`` ones through the kernels, nothing skipped, the chain
   baseline waived), the lint, and the SASS gate on the built kernels
   (every back edge a tagged loop or the compiler's own; every counted
   loop's trips, from the counting build of the same sources, within its
   bound on every launch over the gate's fleets, with outputs bit-exact
   with this build's and a seeded ω = 4 evaluation failing the ω loops;
   healthy and storm fleets flat, also on the serving fleet of 1000 in
   1024 with 250 failed at 2^20 keys; each function within its SASS
   budget); one summary line, the loop table, the JSON report under
   ``ct-report/``;
2. every kernel instance (route, ingest, lookup_dyn, lookup_vec x
   binomial, jump) against its plain torch version on the card,
   bit-exact, at 2^20 keys over several fleets (lookup_dyn also at n <= 1,
   2^23, 2^23 + 1 and 2^31 - 1, and with its n rewritten on the device
   between two launches; lookup_vec over several static n), and a
   4,096-key sample against the scalar oracle; every kernel at ragged
   sizes around a warp, a warp's chunk and a block's pass;
   ``lookup_router`` (the MoE router's keys built in the launch) at the
   serve path's shapes and at 2^20 keys; the placement kernels (the route
   kernel over a key's r salted families, ``route_family``, and the
   distinct-resolution pass, ``resolve``, with and without the moved mask,
   and ``place``, both in one launch) against their plain versions at 2^20
   keys over the same fleets at
   r = 1, 3 and 5, with a too-small ``max_resalt`` where keys exhaust, at
   the ragged sizes, and a 4,096-key sample against a scalar placement
   computed on the host from the ``FailureDomain``; the same at r = 9, 16,
   17, 32, 33 and 64 (resolve's row path past its register columns), and
   the row path at its launch's edges (sizes around a warp's round of 32
   keys, ``max_resalt`` r, 0 and 1, n_alive above and below r, r = 2000
   whose 32 rows outgrow a block's shared memory and r = 30000 whose rows
   are staged in the output; each launch's grid and keys a warp as the
   library reckons them); the
   instrumented route ``route_load`` over the fleets and capacities 4,096
   and 4,097 (either side of its shared histogram), 8,192 and 2^20, at
   sample shifts 0, 3 and 6 and ragged sizes up to a pass of its resident
   grid (one tile, seven and fourteen tiles among them), from accumulators
   near 2^32, against its plain version and ``route`` (capacities past
   4,096 take its global-count instance); the chain-mode remap ``chain_remap`` over the
   seven fleets and 1000/1024 at 6, 50 and 90 % failed (chain-mode control
   planes), ``max_chain`` 0, 1, 2, 8 and 4096, at the ragged sizes, 2^20
   keys and sizes around the ring's carry-over from chunk to chunk (one,
   two and three passes of the resident grid), against its plain version
   (one launch per call), and with its ``lookup_dyn`` first pass against
   the scalar chain oracle; the training kernels: ``adamw_update`` over
   every case it takes (gradient and parameter bf16 or float32, master
   weights on or off, the clip's scale or none) at 2^26 + 12,345 elements,
   aligned, at one offset and at offsets no index aligns, 0 differing
   elements in m, v, master and parameter against its plain version; the
   radix select (three ``radix_hist`` + ``radix_pick`` rounds) against
   ``torch.topk``'s k-th value and its plain rounds bit for bit, each
   round's histogram and choice too, at 2^20 values with ties, on NaN,
   inf, signed zeros, subnormals and an unaligned view, and on a
   gradient-like leaf of experts_wi's 805,306,368 elements;
3. the main paths, each with the kernels' launch counts set to 0 just
   before it and read just after:
   - the routing datapath: ``BatchRouter`` on the card, both engines, fused
     and two-pass: ``route_keys`` (CUDA tensor and numpy), ``route_ids``,
     ``route_batch`` and fleet events, bit-exact with a router running the
     plain versions on the CPU; then the bulk static-n lookup through its
     entry points (``ops.binomial_bulk_lookup``, the jump engine's
     ``kernels.lookup_vec``); route, ingest, lookup_dyn and lookup_vec must
     have run;
   - the chain-mode two-pass path (``ops.route_chain_bulk``: lookup_dyn,
     then chain_remap) per engine over a chain-mode plane of 1000 through
     6 %, 25 % and 50 % failed, 100 recovered, a scale-up and a
     scale-down, 2^20 keys at each state: bit-exact with the plain
     versions and the scalar oracle, lookup_dyn and chain_remap each
     launched once per call and nothing else;
   - ``ServingTier`` serving Qwen3-235B-A22B at its published widths, cut
     to 4 layers, bf16, random weights from a seeded generator, with the
     BinomialHash MoE router: 3 replicas, 24 requests of 8 tokens, 8 new
     tokens each, then replica 1 fails and the batch is served again, per
     engine.  Every request is answered, only the failed replica's
     sessions move, every expert id equals the plain lookup's, and the
     static-n lookup ran once per router call, layers x (1 + new tokens)
     times per group served, with none of the key build's torch operators
     in the router call, and the router with ``router_dynamic_n`` gives
     the same expert ids in one lookup_dyn launch per call; one more call
     runs under ``torch.profiler`` for the device's busy share and its
     operator count.  Before it, a reduced float32 model served on the
     card agrees with the same tier on the CPU;
   - "mesh", the multi-device serving path (``torch.distributed``, one
     process per device): (a) a world of one rank over NCCL,
     ``make_local_mesh(1)``: the sharded ``BatchRouter`` at 2^24 seeded
     keys on 1000 replicas of 1024 with 250 failed, per engine, for a host
     batch, a device batch the caller owns (left intact) and with
     ``donate_keys``, bit-exact with the unmeshed ``route_keys``, one route
     launch a batch; its time in turns with the unmeshed route; (b) two
     ranks sharing the card over gloo (spawned, a ``FileStore``, joined
     within ``MESH_JOIN_S``): each routes its block of the 2^24 keys in
     one launch, bit-exact with the unmeshed route's block, the whole batch
     gathered by a c10d all-gather, and a float32 EP MoE layer (reduced
     Qwen3) on a (1, 2) mesh within ``MESH_EP_TOL`` of the same layer
     unmeshed; (c) after the Qwen3 serve below, over its weights:
     ``ServingTier(mesh=(1, 1) mesh, router_spec=...)`` inside
     ``mesh_context(expert_layout="ep")``, 24 requests of 72 tokens, 8 new:
     replica ids bit-exact with the unmeshed tier, every prefill through
     the expert-parallel body and every decode step through the dense
     GShard path (their calls counted), lookup_router once per MoE layer
     and step, route once, each step's logits of a teacher-forced meshed
     run within 0.1 relative L2 of the unmeshed run's, new tokens/s of
     both;
   - then, its weights released, ``ServingTier`` serving DeepSeek-V3 at its
     published widths (MLA ranks 1536/512, 256 experts of 2048, top-8, a
     shared expert, vocab 129,280), bf16, random weights, cut from 61
     layers to the 3 dense and the first 2 MoE layers, the MTP module left
     out, with the hash router per engine and the same traffic and checks
     (lookup_router = 2 MoE layers x (1 + new tokens) x groups), and one
     profiled call; before it a reduced DeepSeek-V3 on the card against
     the CPU;
   - "serve families", one model at a time, each one's weights released
     before the next: the reduced model on the card against the CPU
     (token families through ``ServingTier`` with prompts of 24, past the
     reduced window of 16 and over three SSD chunks of 8; the embeds
     backbones through prefill and three decode steps); then the
     published config at full width and depth in bf16, random weights:
     RecurrentGemma-9B (RG-LRU, sliding-window attention; 38 layers,
     20.9 GB), Mamba2-1.3B (SSD, tied embeddings) and Starcoder2-7B
     (sliding window) through ``ServingTier`` with the serve traffic per
     engine (every request answered, only replica 1's sessions moved,
     route launched twice, lookup_router never; RecurrentGemma's first
     engine also profiled), then MusicGen-medium (sinusoidal positions)
     and Qwen2-VL-7B (M-RoPE) from seeded embeddings; for each, 2
     sequences of a long prompt (2,560 for RecurrentGemma and Mamba2,
     4,608 for Starcoder2: past their windows into the ring caches; 512
     for the embeds backbones) then 8 decode steps, each step's logits
     against a forward pass over the longer sequence (the reference's
     decode-matches-forward check): in bf16 within ``FAMILY_BF16_TOL``
     (relative L2), then with the weights cast to float32 within the
     reference's 2e-3; the decode steps timed beside the floor of the
     bytes each reads;
   - "train": the reduced Qwen3 (hash router, each engine), DeepSeek-V3
     (MLA, the sigmoid router, a shared expert, the MTP loss),
     RecurrentGemma and Mamba2 on the card against the CPU in float32
     with TF32 off: the loss, every metric and gradient within 1e-4,
     expert ids identical, then one AdamW step with ``grad_accum=2`` and
     an active clip; then Qwen3-235B-A22B at its published widths, cut to
     one MoE layer, bf16, AdamW with master weights, remat "full", per
     engine 6 steps over one batch of 2 x 2,048 tokens from
     ``ShardedDataPipeline`` (the counts set to 0 before the steps):
     ``lookup_router`` launched twice a step (the forward and remat's
     recomputation), every expert id equal to the plain lookup's, the
     step-0 loss near ln V and falling, the training forward's
     last-token logits against ``prefill``'s; ms a step, tokens/s, peak
     memory and the step's floor, ``adamw_update`` launched once a leaf a
     step (the clip's scale folded into it), one more step under
     ``repro_torch.roofline.analyze`` (its counted FLOPs beside the
     floor's reckoned ones), and one profiled step (the optimizer and clip
     ranges, the AdamW kernel's device ms a step beside its bound); then,
     the state freed, ``adamw_update`` on the largest leaf in turns with
     ``torch._fused_adamw_`` (the gradient's float32 cast and the bf16 copy
     included) and its plain version; then the launcher
     ``python -m repro_torch.launch.train`` (the 100m preset, 20 steps,
     then resumed to 30 from its checkpoint) and a bf16 checkpoint round
     trip on the card;
   - "mesh train", the multi-device training path: (a) per engine the
     full-width train cell under a one-rank NCCL (1, 1) mesh with fsdp and
     ZeRO-1 applied, 3 steps over ``ShardedDataPipeline``'s steps 0-2,
     against the same steps unmeshed from the same seed (losses within
     1e-3 and grad norms within 1e-2 relative, peak memory within 5 %,
     ``lookup_router`` twice a step, ms a step beside the unmeshed; the
     unmeshed steps also with AdamW's plain version in place of its
     kernel, within the same tolerances, beside the spread of the unmeshed
     steps run twice; ``adamw_update`` once a leaf a meshed step); (b)
     4 gloo ranks sharing the card on a (2, 2) mesh with fsdp, float32,
     TF32 off: reduced Qwen3 (``ep``; ``tp`` with the hash router and full
     remat), DeepSeek-V3, StableLM-3B, Mamba2-1.3B and StableLM variants
     taking the four attention modes, 2 AdamW steps with ZeRO-1, every
     rank's parameter and optimizer blocks within 1e-4 of the unmeshed
     port on the card cut the same way, K5 counted per rank;
   - "compress", gradient compression under a mesh: (a) per engine the
     train cell with Adafactor, int8 then top-k, 3 steps unmeshed and 3
     under a one-rank NCCL (1, 1) mesh with fsdp and ZeRO-1 (losses within
     2e-4, grad norms within 1e-3, ``lookup_router`` twice a step); the
     select's kernels three launches each a leaf a top-k step, meshed and
     unmeshed; in the first top-k step of each every leaf's threshold
     equals ``torch.topk``'s k-th value on the card bit for bit and the
     kept count is k plus the ties; ms a step, the ``train_step/compress``
     range's device ms, the select kernels' device ms over a step's
     leaves, the peak memory by part, and the select on the largest leaf
     (each round's launch, the pick) against its bound, ``torch.topk`` and
     its plain rounds (and without a host synchronisation); (b) 4 gloo ranks
     sharing the card on a (2, 2) mesh with fsdp, reduced Qwen3-MoE (hash
     router) and StableLM-3B, int8 and top-k, 2 AdamW steps, each against
     the unmeshed port's step on the card from the same state: every
     rank's blocks within 1e-4 but for the elements whose compression
     flipped, which are bounded and checked as the CPU tests check them;
   - placement, per engine: ``BatchRouter(1000, capacity=1024)``, a
     ``LifecycleManager`` on a ``ManualClock``, ``StorePlacement(r=3)`` with
     2^20 registered keys and a ``PlacementRepairer``; 2 replicas fall
     silent past ``fail_after`` and the repair quiesces (every key on 3
     distinct live copies); then 250 fall silent at once (one tick: one
     coalesced upload, 250 journaled fails), ``plan_migration`` (moved
     fraction beside delta/n), quiesce (keys whose three holders all failed
     count in ``lost``), journal and placement replay from a mid-run
     snapshot, the 250 readmitted through heartbeats, scale up, scale down;
     the same storyline at 2^16 keys on the card and on the CPU (plain
     versions) gives the same journal bytes, placements, repair tasks,
     ``lost`` and ``completed``;
   - streaming, per engine: ``StreamingFrontEnd`` (``WallClockUs``, the
     default ``StreamConfig``) over that fleet and store with a
     ``LoadMonitor``: 2^16 requests from 8 tenants, 250 replicas silent
     halfway, 2^12 hedged reads; every served replica the scalar oracle's
     at its epoch, every read from a live holder, served == consumed ==
     request spans == drained keys, peak/mean inside the envelope, no
     alarm, one ``route_load`` launch per dispatch and one ``route`` launch
     per probe re-route; then two storylines of ``tests/chaos.py``
     (overload, latency_spike), cut down, on a ``VirtualClockUs`` on the
     card and on the CPU give the same results and JSON bytes;
   - "examples": each of the seven ``examples/*_torch.py`` (quickstart,
     serve_lm, train_lm, elastic_cluster, placement_demo,
     observability_demo, streaming_demo) through its ``main(["--device",
     "cuda"])`` in this process, then ``main(["--device", "cpu"])``: the two
     outputs equal line for line with the wall times, the device and the
     numbers that follow the random weights masked, and the quickstart's
     CUDA kernel matching its plain path;
4. each kernel's time at 2^24 keys (CUDA events around back-to-back
   launches) beside its bound and its plain version's time; the static-n
   lookup also at n = 1025; ``lookup_router`` at 2^24 router keys and, as
   the serve path calls it, at the serve path's own sizes: device time per
   launch (the launches queued behind a sleeping kernel, so the card runs
   them back to back) and the wrapper's host time per call; the
   placement pass (``place_keys``: one ``place`` launch) and the migration
   diff (``plan_migration``, two) at 2^24 keys, r = 3, on the fleet of 1000
   with 250 failed, the family route and resolve alone, each beside its
   bound; ``place`` against the family route and resolve it replaces, in
   turns, alone and with the old rows, on 200 of 256 healthy and with 50
   failed (the store cells' fleet) and on 1000 of 1024 with 250 failed,
   beside its bound (17 B an object against the family route's and the
   resolution's operations);
   ``BatchRouter.route_keys`` at 2^24 keys on the healthy fleet and with
   250 failed (the storm/steady ratio); ``route_load`` at 2^24 and 2^20
   keys, shifts 6 and 0, on that fleet and on 40000/65536 (its
   global-count instance), against ``route`` in turns (instrumented/bare
   and the extra us), beside its bound, its plain version and ``route`` +
   ``torch.bincount`` at 2^24, and route alone there against its own
   bound (the route body's share);
   ``place_keys`` at 2^20 keys, r = 16, and ``resolve_kernel<false>`` (its
   row path) alone there with and without ``old`` beside each bound (the
   function's own bytes) and its plain version; and
   the storm cliff: the chain-mode two-pass path against ``route``
   (table) at 2^24 keys in turns at 0, 6, 25 and 50 % failed,
   ``chain_remap`` alone beside its bound, with the walk steps per lane of
   its resident grid beside the per-warp-maximum walk that one thread per
   key would issue; then the erasure-coded store (``phase_racks``: 20
   racks of 10 with 20 DataNodes down, 2^24 block groups at r = 9, each
   engine): ``place_keys`` in three launches (the family route,
   ``resolve``'s row path, ``node_route``), counted from 0 just before it;
   ``place`` over the rack fleet and ``node_route``, each without and with
   ``old``, bit-exact against their plain versions; their times beside
   their bounds (``node_route``: 76 B a group against the route of its 9
   node keys a group) and their plain versions' times.

``--baseline DIR [DIR ...]`` also builds each ``DIR/train.cu`` there is
(another build of the training kernels) and times the select's rounds
and the select against this build's in turns, and each ``DIR/routing.cu``
(another
build of the kernels with the same C interface: the parent commit's, or a
variant of this one) and times it against this one in turns (baseline,
this, this, baseline), three rounds: every instance at 2^24 keys,
resolve's register path (r = 3) there and its row path at 2^20 keys x
r = 16 with and without ``old`` (both builds' answers equal),
``chain_remap`` at each failed share of the storm sweep, ``route_load`` in
each of phase 4's cells and the host time of a monitored 64-key
``route_keys``, and the router call at the serve path's sizes (a baseline
without ``routing_lookup_router`` builds its keys with torch).

Then a ``{"kernels": [...]}`` line (each routing kernel per engine, then
``adamw_update``, ``radix_hist`` and ``radix_pick``), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
with no result line; so does a machine with no CUDA device, or a copy of
this file without the rest of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke: run from a checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.sass_gate import FUNCTIONS  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

SRC = "src/repro_torch/kernels/csrc/routing.cu"
#: the TPU kernels replaced: each kind's pallas_call in the JAX package
REPLACES = {
    "route": "src/repro/kernels/fused.py:202",
    "ingest": "src/repro/kernels/fused.py:255",
    "lookup_dyn": "src/repro/kernels/fused.py:295",
    "lookup_vec": "src/repro/kernels/binomial_hash.py:91",
    "lookup_router": "src/repro/kernels/binomial_hash.py:91",
    "route_family": "src/repro/placement/store.py:87 (its family route: the K1/K2 pallas_call, "
                    "src/repro/kernels/fused.py:202)",
    "resolve": "src/repro/placement/store.py:131 (jnp in the JAX package; no pallas_call)",
    "place": "src/repro/placement/store.py:87 and :131 (the family route on the K1/K2 "
             "pallas_call, src/repro/kernels/fused.py:202, then the jnp resolve), in one launch",
    "route_load": "src/repro/observability/load.py:71 (route_with_load_impl: jnp in the JAX "
                  "package, no pallas_call; its route is the K1/K2 pallas_call, "
                  "src/repro/kernels/fused.py:202)",
    "chain_remap": "src/repro/core/memento_jax.py:101 (memento_remap: a jnp lax.while_loop in "
                   "the JAX package, no pallas_call)",
    "node_route": "none: the JAX package has no failure domains (the route's K1/K2 pallas_call, "
                  "src/repro/kernels/fused.py:202, is its body)",
}
ENGINES = ("binomial", "jump")
#: the kernels that read a fleet (the routing datapath), and all kernels
FLEET_KINDS = ("route", "ingest", "lookup_dyn")
KINDS = (*FLEET_KINDS, "lookup_vec")
#: The per-key SASS instruction counts of the kernels' first build (the
#: yardstick): counted by hand along the common path in ``cuobjdump -sass``
#: of that sm_90a build (CUDA 12.9), whose kernels ran one thread per key
#: through an early-exit loop: ``key`` outside the lookup loop (thread
#: prologue, loads, the splitmix64 of ingest, the mask test, the store;
#: less the part of the exiting iteration it skips), ``iter`` per loop
#: trip, ``fold`` for binomial's block A/C relocation, ``divert`` for a
#: removed bucket and ``deep`` for its second redirect.  Phase 4 prints the
#: share against it (the fold charged wherever block A or C is the exit)
#: beside the bound, so that the first build's shares can be compared.
YARDSTICK = {
    ("binomial", "route"): dict(key=68, iter=44, fold=26, divert=31, deep=11),
    ("binomial", "ingest"): dict(key=90, iter=44, fold=26, divert=31, deep=11),
    ("binomial", "lookup_dyn"): dict(key=53, iter=44, fold=26, divert=0, deep=0),
    ("jump", "route"): dict(key=52, iter=32, fold=0, divert=31, deep=11),
    ("jump", "ingest"): dict(key=74, iter=32, fold=0, divert=31, deep=11),
    ("jump", "lookup_dyn"): dict(key=37, iter=31, fold=0, divert=0, deep=0),
    # the static-n kernel: n, E and M arrive as launch arguments, so the
    # binomial key path drops the n load and the next-pow2 cascade (-14)
    # and the jump key path the n load (-1); the loops are the same
    ("binomial", "lookup_vec"): dict(key=39, iter=44, fold=26, divert=0, deep=0),
    ("jump", "lookup_vec"): dict(key=36, iter=31, fold=0, divert=0, deep=0),
}
#: SASS instructions of one step of the redesigned jump chains
#: (``jump_chains`` in routing.cu, sm_90a, n <= 2^23): the LCG, the I2F and
#: the IEEE division (``MUFU.RCP``, its ``FCHK`` and refinement), the
#: product, the compare and the b + 1 update; counted like the yardstick.
#: The first build's step took 31-32 (``iter`` above).
JUMP_STEP = 24
#: The bound's counts: the yardstick's, with every jump step at the fewest
#: instructions a build of this repo takes for it (``JUMP_STEP``), and
#: lookup_dyn's key path at lookup_vec's: its thread loads n and folds E and
#: M once for all its keys, not the next-pow2 cascade per key that the
#: yardstick charges.  The bound charges the fold only where the lookup
#: needs it (block A left on a trip after the first, or block C): on the
#: first trip block A's fold equals the candidate (``Binomial::first_trip``).
#: A kernel that does the same work in fewer instructions can beat the
#: bound: its bound/time share then exceeds 1, and phase 4 prints it so.
WORK = {
    (engine, kind): dict(
        c, key=YARDSTICK[engine, "lookup_vec"]["key"] if kind == "lookup_dyn" else c["key"],
        iter=JUMP_STEP if engine == "jump" else c["iter"])
    for (engine, kind), c in YARDSTICK.items()
}
#: each kernel function's whole SASS size (instructions) in the build this
#: table was counted from (sm_90a, by the card machine's nvcc);
#: ``lookup_router`` is the static-n kernel over the router's key source,
#: a separate function, so it has its own row in the kernels line.
#: Phase 1 fails if the build differs, so an edit of ``routing.cu`` or
#: another compiler forces a recount.
SASS_STATIC = {
    ("binomial", "route"): 1568, ("binomial", "ingest"): 1968, ("binomial", "lookup_dyn"): 1112,
    ("binomial", "lookup_vec"): 1088, ("binomial", "lookup_router"): 1264,
    ("jump", "route"): 1216, ("jump", "ingest"): 1296, ("jump", "lookup_dyn"): 928,
    ("jump", "lookup_vec"): 928, ("jump", "lookup_router"): 1136,
    ("binomial", "route_family"): 1904, ("jump", "route_family"): 1328,
    ("binomial", "resolve"): 664, ("jump", "resolve"): 664,
    # resolve's row path (r > MAX_R), and the instrumented route with its
    # histogram in shared memory (capacity <= 4,096) and with the global
    # count (read back after each chunk, or at shift 0 added in the loop)
    ("binomial", "resolve_rows"): 1768, ("jump", "resolve_rows"): 1768,
    ("binomial", "route_load"): 1848, ("jump", "route_load"): 1464,
    ("binomial", "route_load_global"): 3000, ("jump", "route_load_global"): 2304,
    # the chain-mode remap, one function for both engines
    ("binomial", "chain_remap"): 768, ("jump", "chain_remap"): 768,
    # the family route and the resolution in one launch (r <= 8)
    ("binomial", "place"): 2904, ("jump", "place"): 2376,
    # the node level of a placement over failure domains (PR 33)
    ("binomial", "node_route"): 1888, ("jump", "node_route"): 1336,
}
#: bytes each kernel must move per key: keys (or two id halves) in, ids out
BYTES_PER_KEY = {"route": 8, "ingest": 12, "lookup_dyn": 8, "lookup_vec": 8}
#: the placement kernels: the route kernel over a key's r salted families,
#: the distinct-resolution pass, and both in one launch (r <= 8)
PLACEMENT_KINDS = ("route_family", "resolve", "place")
#: the kernels line's rows: every kind, the router's static-n lookup, the
#: placement kernels, the instrumented route, the chain remap, then the
#: node level over failure domains
ROWS = (*KINDS, "lookup_router", *PLACEMENT_KINDS, "route_load", "chain_remap", "node_route")

N_CHECK = 1 << 20  # the repo's acceptance batch (benchmarks/bench_router.py)
N_TIME = 1 << 24
N_ORACLE = 4096
#: static n for the lookup_vec checks: the pow2 edges, the paper's cluster
#: sizes (configs.PAPER_BENCH) and 2^23 + 1, past which the jump chains
#: leave their exact-f32 step; n = 1000 for its times, as lookup_dyn
VEC_NS = (2, 3, 10, 11, 100, 128, 1000, 1023, 1024, 1025, 10000, 65536, 100000, (1 << 23) + 1)
VEC_N_TIME = 1000
#: runtime n for the lookup_dyn checks past the fleets': n <= 1 (zeros, from
#: a launch), the jump chains' exact-f32 edge (2^23) and the first n past
#: it, and the top of the int32 n the JAX package shares (2^31 - 1)
DYN_NS = (0, 1, 2, 1 << 23, (1 << 23) + 1, (1 << 31) - 1)
#: n where half the binomial keys go past the loop's first trip
VEC_N_HALF = 1025
#: key counts around a warp (32), a warp's chunk (256 = 32 lanes x 8 keys)
#: and a block's pass (2,048) of the redesigned kernels, and past two passes
TAIL_SIZES = (1, 31, 33, 255, 257, 2047, 2049, 4097)
#: token-id shapes of the router calls checked: the serve path's (decode and
#: prefill groups of 1-16 requests of 8 tokens), then 2^20 keys at top-8
ROUTER_SHAPES = ((1, 1), (13, 1), (16, 1), (13, 8), (16, 8), (1024, 128))
ROUTER_SALTS = (0, 1, 93)

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


# --- the constant-time certificate -------------------------------------------

#: where the certify phase writes its JSON report (git ignores it)
CT_REPORT = ROOT / "ct-report" / "chip_smoke.json"


def phase_certify(card: str) -> None:
    """The constant-time certifier (``repro_torch.analysis``) on the card:
    layer 1 over every target of both engines (the ``/cuda`` ones and the
    composite paths through the kernels), the lint, and the SASS gate on
    this build.  Fails on any unwaived failure, on a target none of whose
    checks ran, and on any skipped SASS check."""
    from repro_torch.analysis.certify import certify_all
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.analysis.report import FAIL, SKIPPED, WAIVED
    from repro_torch.analysis.sass_gate import gate_all, loop_table

    t0 = time.perf_counter()
    report = certify_all(device="cuda")
    report.lint = lint_paths()
    report.sass = gate_all(device="cuda")
    seconds = time.perf_counter() - t0
    CT_REPORT.parent.mkdir(exist_ok=True)
    CT_REPORT.write_text(report.to_json() + "\n")
    verdicts = {}
    for t in report.targets:
        statuses = {c.status for c in t.checks}
        verdicts[f"{t.engine} {t.target}"] = (
            "fail" if FAIL in statuses else "skipped" if statuses == {SKIPPED}
            else "waived" if WAIVED in statuses else "pass")
    counts = {v: sum(x == v for x in verdicts.values()) for v in ("pass", "waived", "fail", "skipped")}
    sass_skipped = [f"{s.engine} {c.invariant}" for s in report.sass for c in s.checks
                    if c.status == SKIPPED]
    seen, edges = set(), []
    for (engine, kind), prefix in FUNCTIONS.items():
        if prefix in seen:
            continue
        seen.add(prefix)
        fl = loop_table([(engine, kind)])[f"{kind}[{engine}]"]
        tags = " ".join(f"{b}x{n}" for b, n in sorted(fl.bounds().items()))
        label = kind if kind in ("resolve", "resolve_rows", "chain_remap") else f"{kind}[{engine}]"
        edges.append(f"{label} {tags} +{fl.rejoins} rejoin +{fl.pads} pad")
    print(f"phase 1 certify: {len(verdicts)} targets on cuda: {counts['pass']} pass, "
          f"{counts['waived']} waived ({', '.join(k for k, v in verdicts.items() if v == 'waived')}), "
          f"{counts['fail']} fail, {counts['skipped']} skipped; lint "
          f"{'clean' if not report.lint else f'{len(report.lint)} findings'}; SASS gate "
          + ", ".join(f"{s.engine} {'ok' if s.ok else 'FAIL'}" for s in report.sass)
          + "; back edges by function (loops by their ct-loop bound, then the compiler's rejoins "
          "and pads): " + "; ".join(edges)
          + f"; {seconds:.1f} s; report {CT_REPORT.relative_to(ROOT)} on {card}")
    from repro_torch.analysis.report import render_trip_table

    for s in report.sass:
        for c in s.checks:
            if c.invariant in ("sass-severity-flat", "sass-loops-bounded"):
                print(f"phase 1 certify {s.engine} {c.invariant} {c.status}: {c.detail}")
        if s.trips:
            print(f"phase 1 certify {s.engine} loop table (the counting build's largest trips of "
                  f"one entry, or steps of one key, against the bound on each launch; on {card}):")
            print("\n".join("    " + row for row in render_trip_table(s.trips)))
    if not report.ok or counts["skipped"] or sass_skipped:
        print(report.render())
        fail(f"certify: {counts['fail']} targets failed, {counts['skipped']} skipped, lint "
             f"{len(report.lint)} findings, SASS checks skipped {sass_skipped}, SASS gate "
             f"{[s.engine for s in report.sass if not s.ok]} failed")


# --- fleets -----------------------------------------------------------------


def make_fleet(engine: str, n: int, capacity: int, n_fail: int, seed: int):
    """(control plane, device FleetState) with ``n_fail`` random slots of
    ``[0, n-1)`` failed."""
    from repro_torch.core.bulk import FleetState
    from repro_torch.core.registry import make_bulk
    from repro_torch.serving.router import SessionRouter

    plane = SessionRouter(n, engine=make_bulk(engine).scalar_engine, chain_bits=32,
                          resolve="table", allow_empty=True)
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
        phase_lookup_dyn(engine, kernels, keys, max_err)
        phase_lookup_vec(engine, kernels, keys, max_err)


def phase_lookup_dyn(engine, kernels, keys, max_err: dict) -> None:
    """The dynamic-n kernel at ``DYN_NS`` against its plain version
    (bit-exact) and the scalar oracle, every n from a launch; then one ``n``
    tensor rewritten on the device between two launches, with the host
    never synchronising (CUDA's sync debug mode raises if it does)."""
    from repro_torch.core.binomial import binomial_lookup32
    from repro_torch.core.jump import jump_lookup32

    oracle32 = binomial_lookup32 if engine == "binomial" else jump_lookup32
    sample = keys[:N_ORACLE].cpu().numpy().view(np.uint32)

    def compare(n_value: int, got) -> tuple[int, int]:
        want = kernels.lookup_dyn_plain(keys, torch.tensor([n_value], dtype=torch.int32,
                                                           device=keys.device))
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err[engine, "lookup_dyn"] = max(max_err.get((engine, "lookup_dyn"), 0), err)
        expect = np.asarray([oracle32(int(k), n_value, 16) for k in sample])
        return err, int((got[:N_ORACLE].cpu().numpy() == expect).sum())

    for n_value in DYN_NS:
        launched = kernels.launches["lookup_dyn"]
        got = kernels.lookup_dyn(keys, torch.tensor([n_value], dtype=torch.int32, device=keys.device))
        torch.cuda.synchronize()
        err, n_ok = compare(n_value, got)
        print(f"phase 2 lookup_dyn[{engine}] n={n_value}: {N_CHECK} keys, max |kernel - plain| = "
              f"{err}, oracle {n_ok}/{N_ORACLE}")
        if err or n_ok != N_ORACLE or kernels.launches["lookup_dyn"] != launched + 1:
            fail(f"lookup_dyn[{engine}] at n = {n_value} disagrees or did not launch")
    n = torch.tensor([VEC_N_TIME], dtype=torch.int32, device=keys.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = kernels.lookup_dyn(keys, n)
        n.fill_(VEC_N_HALF)  # a device write, queued behind the first launch
        second = kernels.lookup_dyn(keys, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    checks = [compare(VEC_N_TIME, first), compare(VEC_N_HALF, second)]
    print(f"phase 2 lookup_dyn[{engine}] one n rewritten on the device between two launches, no "
          f"host sync: n={VEC_N_TIME} then n={VEC_N_HALF}: max |kernel - plain| = "
          f"{max(e for e, _ in checks)}, oracle {', '.join(f'{k}/{N_ORACLE}' for _, k in checks)}")
    if any(e or k != N_ORACLE for e, k in checks):
        fail(f"lookup_dyn[{engine}] does not follow n rewritten on the device")


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


def phase_tails(max_err: dict) -> None:
    """The kernels at ragged sizes: every instance against its plain
    version (lookup_vec at n = 1000 and 1025) on a fleet with 250 of 1000
    replicas failed."""
    from repro_torch.core.registry import make_bulk

    rng = np.random.default_rng(3)
    keys = u32_tensor(rng, max(TAIL_SIZES)).cuda()
    hi = u32_tensor(rng, max(TAIL_SIZES)).cuda()
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        _, fleet = make_fleet(engine, 1000, 1024, 250, 2)
        worst = 0
        for size in TAIL_SIZES:
            k, h = keys[:size], hi[:size]
            pairs = [(kind, run_kind(kernels, kind, k, h, fleet, plain=False),
                      run_kind(kernels, kind, k, h, fleet, plain=True)) for kind in KINDS]
            pairs.append(("lookup_vec", kernels.lookup_vec(k, VEC_N_HALF),
                          kernels.lookup_vec_plain(k, VEC_N_HALF)))
            torch.cuda.synchronize()
            for kind, got, want in pairs:
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                max_err[engine, kind] = max(max_err.get((engine, kind), 0), err)
                worst = max(worst, err)
                if err or got.shape != want.shape:
                    fail(f"{kind}[{engine}] at {size} keys disagrees with its plain version")
        print(f"phase 2 tails[{engine}]: route, ingest, lookup_dyn, lookup_vec (n = {VEC_N_TIME}, "
              f"{VEC_N_HALF}) at {', '.join(map(str, TAIL_SIZES))} keys: max |kernel - plain| = "
              f"{worst}")


def phase_lookup_router(max_err: dict) -> None:
    """``lookup_router`` (the static-n kernel building the MoE router's
    keys from token ids) against its plain version, for int64 and int32
    ids, bit-exact; a 4,096-key sample against the scalar oracle."""
    from repro_torch.configs import get_config
    from repro_torch.core.binomial import binomial_lookup32
    from repro_torch.core.binomial_torch import router_keys
    from repro_torch.core.jump import jump_lookup32
    from repro_torch.core.registry import make_bulk

    m = get_config(SERVE_ARCH).moe
    rng = np.random.default_rng(4)
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        oracle32 = binomial_lookup32 if engine == "binomial" else jump_lookup32
        worst, n_ok = 0, 0
        for shape in ROUTER_SHAPES:
            tokens = torch.from_numpy(rng.integers(0, get_config(SERVE_ARCH).vocab_size,
                                                   size=shape)).cuda()
            for salt in ROUTER_SALTS:
                want = kernels.lookup_router_plain(tokens, salt, m.top_k, m.num_experts)
                for ids in (tokens, tokens.to(torch.int32)):
                    got = kernels.lookup_router(ids, salt, m.top_k, m.num_experts)
                    torch.cuda.synchronize()
                    if got.shape != want.shape:
                        fail(f"lookup_router[{engine}] gave shape {tuple(got.shape)}")
                    worst = max(worst, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
            keys = router_keys(tokens, salt, m.top_k).reshape(-1)[:N_ORACLE].cpu().tolist()
            expect = np.asarray([oracle32(k, m.num_experts, 16) for k in keys])
            n_ok += int((got.reshape(-1)[:N_ORACLE].cpu().numpy() == expect).all())
        max_err[engine, "lookup_router"] = worst
        print(f"phase 2 lookup_router[{engine}]: token ids {list(ROUTER_SHAPES)} (int64 and int32) "
              f"x layer salts {ROUTER_SALTS}, top-{m.top_k} of n = {m.num_experts}: "
              f"max |kernel - plain| = {worst}; oracle agrees on {n_ok}/{len(ROUTER_SHAPES)} shapes")
        if worst or n_ok != len(ROUTER_SHAPES):
            fail(f"lookup_router[{engine}] disagrees")


# --- the placement kernels --------------------------------------------------

#: replication factors checked: a single copy, Cassandra's and Ceph's default
#: of 3 (``replication_factor``, ``osd_pool_default_size``), and 5
PLACEMENT_RS = (1, 3, 5)
#: the placement path's replication factor
PLACE_R = 3


def scalar_placement(domain, key: int, r: int, max_resalt: int) -> tuple[list[int], bool]:
    """One key's R-way placement computed on the host from the scalar
    control plane (``FailureDomain.locate`` of each salted family, then the
    re-salt probes over the replacement table's alive prefix): -> (the r
    shards, exhausted)."""
    from repro_torch.core import bits
    from repro_torch.core.placement_torch import RESALT_SALT, family_salts

    n_alive, slots = domain.alive_count, domain.replacement_table.slots
    cols, exhausted = [], False
    for j, salt in enumerate(family_salts(r).tolist()):
        fam = bits.mix32(key ^ salt)
        b = domain.locate(fam)
        if b in cols:
            q = bits.mulhi32(bits.mix32(fam ^ RESALT_SALT), n_alive)
            for _ in range(max_resalt):
                if slots[q] not in cols:
                    b = slots[q]
                    break
                q = q + 1 - n_alive if q + 1 >= n_alive else q + 1
            else:
                exhausted = exhausted or j < n_alive
        cols.append(b)
    return cols, exhausted


def _max_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want) if g is not None)


def check_placement(kernels, keys, fleet, r: int, max_resalt: int, old=None):
    """The family route and resolve, and ``place`` (both in one launch), on
    the card against their plain versions on the same inputs -> (the
    kernels' (replicas, exhausted, moved), max |kernel - plain| of the
    family route, of resolve and of place)."""
    args = (fleet.packed, fleet.table, fleet.state)
    base = kernels.route_family(keys, r, *args)
    want_base = kernels.route_family_plain(keys, r, *args)
    got = kernels.resolve(keys, base, fleet.table, fleet.state, max_resalt, old)
    want = kernels.resolve_plain(keys, base, fleet.table, fleet.state, max_resalt, old)
    placed = kernels.place(keys, r, *args, 16, max_resalt, old)
    torch.cuda.synchronize()
    err_route = int((base.to(torch.int64) - want_base.to(torch.int64)).abs().max()) if base.numel() else 0
    err_resolve, err_place = _max_err(got, want), _max_err(placed, want)
    if base.shape != want_base.shape or any(
            (g is None) != (w is None) or (g is not None and g.shape != w.shape)
            for g, w in (*zip(got, want), *zip(placed, want))):
        fail(f"route_family/resolve/place[{kernels.name}] at r = {r} gave other shapes")
    return got, err_route, err_resolve, err_place


def phase_placement_kernels(max_err: dict) -> None:
    """``route_family`` and ``resolve`` against their plain versions at
    2^20 keys over the fleets of ``fleets`` at r in ``PLACEMENT_RS`` (the
    default ``max_resalt``, and resolve with the previous fleet's placement
    as ``old`` for the moved mask), bit-exact, and a 4,096-key sample
    against ``scalar_placement``; ``max_resalt = 1`` where keys exhaust, with
    the plain version's exhausted count; the ragged sizes."""
    from repro_torch.core.registry import make_bulk

    rng = np.random.default_rng(5)
    keys = u32_tensor(rng, N_CHECK).cuda()
    sample = keys[:N_ORACLE].cpu().numpy().view(np.uint32).tolist()
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        last: dict = {}
        for label, (plane, fleet) in fleets(engine).items():
            report = []
            for r in PLACEMENT_RS:
                (rep, exhausted, moved), e_route, e_res, e_place = check_placement(
                    kernels, keys, fleet, r, r, last.get(r))
                last[r] = rep
                for kind, err in (("route_family", e_route), ("resolve", e_res), ("place", e_place)):
                    max_err[engine, kind] = max(max_err.get((engine, kind), 0), err)
                host = [scalar_placement(plane.domain, k, r, r) for k in sample]
                n_ok = int((rep[:N_ORACLE].cpu().numpy() == np.asarray([c for c, _ in host])).all(1).sum())
                n_ok_ex = int((exhausted[:N_ORACLE].cpu().numpy() == np.asarray([x for _, x in host])).sum())
                distinct = int((rep.sort(1).values.diff(1) != 0).sum(1).add(1).min())
                report.append(f"r={r}: max |kernel - plain| = {e_route}/{e_res}/{e_place}, host placement "
                              f"{n_ok}/{N_ORACLE}, exhausted {int(exhausted.sum())}, fewest distinct "
                              f"{distinct}" + ("" if moved is None else f", moved {int(moved.sum())}"))
                if e_route or e_res or e_place or n_ok != N_ORACLE or n_ok_ex != N_ORACLE or exhausted.any() \
                        or distinct != min(r, plane.domain.alive_count):
                    fail(f"placement[{engine}] on fleet {label} at r = {r} disagrees")
            print(f"phase 2 placement[{engine}] fleet {label}, {N_CHECK} keys (route_family/resolve/place): "
                  + "; ".join(report))
        # a too-small probe bound: exhaustion, counted as the plain version counts it
        for label, plane, fleet in (("1000/1024 250 failed", *make_fleet(engine, 1000, 1024, 250, 2)),
                                    ("8/64", *make_fleet(engine, 8, 64, 0, 8))):
            (rep, exhausted, _), e_route, e_res, e_place = check_placement(kernels, keys, fleet, 5, 1)
            host = [scalar_placement(plane.domain, k, 5, 1) for k in sample]
            n_ok_ex = int((exhausted[:N_ORACLE].cpu().numpy() == np.asarray([x for _, x in host])).sum())
            want = kernels.resolve_plain(keys, kernels.route_family_plain(
                keys, 5, fleet.packed, fleet.table, fleet.state), fleet.table, fleet.state, 1)[1]
            print(f"phase 2 placement[{engine}] fleet {label}, r=5, max_resalt=1: exhausted "
                  f"{int(exhausted.sum())} (plain {int(want.sum())}), max |kernel - plain| = "
                  f"{e_route}/{e_res}/{e_place}, host exhausted flags {n_ok_ex}/{N_ORACLE}")
            if e_route or e_res or e_place or int(exhausted.sum()) != int(want.sum()) \
                    or n_ok_ex != N_ORACLE \
                    or (label == "8/64" and not exhausted.any()):
                fail(f"placement[{engine}] exhaustion on fleet {label} disagrees")
        _, fleet = make_fleet(engine, 1000, 1024, 250, 2)
        tails = u32_tensor(np.random.default_rng(6), max(TAIL_SIZES)).cuda()
        worst = 0
        for size in TAIL_SIZES:
            for r in (PLACE_R, 5, 16):
                _, *errs = check_placement(kernels, tails[:size], fleet, r, r, None)
                worst = max(worst, *errs)
        print(f"phase 2 placement tails[{engine}]: route_family, resolve and place at r = {PLACE_R}, 5 "
              f"and 16, "
              f"{', '.join(map(str, TAIL_SIZES))} keys: max |kernel - plain| = {worst}")
        if worst:
            fail(f"placement[{engine}] at the ragged sizes disagrees")


# --- the instrumented route -------------------------------------------------

#: sample shifts checked: every key, and the two strides
LOAD_SHIFTS = (0, 3, 6)
#: key counts of the route_load checks: ragged around a warp and a block's
#: pass, the acceptance batch, and the launch's edges at a small batch (one
#: key a lane, so a tile is 256 keys): one tile, seven tiles and fourteen
#: (the last ragged); ``load_sizes`` adds a full pass of the resident grid
#: and one key past it
LOAD_SIZES = (1, 31, 33, 256, 7 * 256, 13 * 256 + 5, 4097, N_CHECK)
#: the shared-histogram threshold (routing.cu's SHARED_BINS), and the grids
#: the small edges must launch (one block a tile)
SHARED_BINS = 4096
LOAD_EDGE_GRIDS = {256: 1, 7 * 256: 7, 13 * 256 + 5: 14}


def load_grid(engine: str, n: int, capacity: int) -> int:
    """route_load's grid for ``n`` keys at ``capacity``, from the library's
    own launch shape."""
    from repro_torch.kernels import build

    grid = build.library().routing_route_load_grid(ENGINES.index(engine), n, capacity)
    if grid < 1:
        fail(f"route_load[{engine}]'s grid query failed ({grid})")
    return grid


def load_sizes(engine: str, capacity: int) -> tuple:
    """``LOAD_SIZES``, then one full pass of the resident grid (every warp
    one chunk of 256 keys) and one key past it (a warp takes a second
    chunk)."""
    keys = load_grid(engine, 1 << 40, capacity) * 256 * 8
    return (*LOAD_SIZES, keys, keys + 1)


def load_fleets(engine: str) -> dict:
    """``fleets`` and the two sides of the shared-histogram threshold:
    capacity 4,096, and 4,097 (no fleet has it, as a capacity is a power of
    two: 4,097 bins of the 8,192-slot fleet's table and its mask words for
    them, which route as the whole do, since n = 3000); then the global
    instance's capacities 8,192 and 2^20."""
    cases = fleets(engine)
    cases["3000/4096 750 failed"] = make_fleet(engine, 3000, 4096, 750, 8)
    cases["6000/8192 1500 failed"] = make_fleet(engine, 6000, 8192, 1500, 10)
    cases["600000/1048576 1000 failed"] = make_fleet(engine, 600000, 1 << 20, 1000, 11)
    plane, fleet = make_fleet(engine, 3000, 8192, 750, 8)
    cases["3000/4097 750 failed"] = (plane, dataclasses.replace(
        fleet, packed=fleet.packed[:(SHARED_BINS + 32) // 32], table=fleet.table[:SHARED_BINS + 1]))
    return cases


def near_wrap(rng, capacity: int) -> torch.Tensor:
    """A (capacity,) accumulator on the card whose every bin starts within
    2^10 of 2^32 (u32 bit patterns in int32)."""
    start = (2**32 - rng.integers(1, 1 << 10, capacity)).astype(np.uint32)
    return torch.from_numpy(start.view(np.int32)).cuda()


def u32_err(got, want) -> int:
    """max |got - want| of two int32 tensors read as u32 (0 for empty)."""
    if not got.numel():
        return 0
    return int(((got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max())


def phase_route_load(max_err: dict) -> None:
    """``route_load`` over ``load_fleets`` (capacity 64 to 2^20, either
    side of the shared-histogram threshold) at every shift of
    ``LOAD_SHIFTS`` and size of ``load_sizes``, from an accumulator near
    2^32: its replica ids bit-exact with ``route`` and its plain version,
    its counts with the plain version's, one launch per call; a 4,096-key
    sample against the scalar oracle.  The small edge sizes must launch the
    grids of ``LOAD_EDGE_GRIDS``."""
    from repro_torch.core.registry import make_bulk

    rng = np.random.default_rng(7)
    keys = u32_tensor(rng, 4 * N_CHECK).cuda()  # past the largest resident pass
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        grids = {n: load_grid(engine, n, 1024) for n in LOAD_EDGE_GRIDS}
        if grids != LOAD_EDGE_GRIDS:
            fail(f"route_load[{engine}]'s grids {grids} are not the edges checked: {LOAD_EDGE_GRIDS}")
        print(f"phase 2 route_load[{engine}] grids at capacity 1024: " + ", ".join(
            f"{n} keys {g} blocks" for n, g in grids.items()) + f"; a resident pass "
              f"{load_sizes(engine, 1024)[-2]} keys ({load_grid(engine, 1 << 40, 1024)} blocks); "
              f"capacity 65,536: {load_sizes(engine, 65536)[-2]} keys "
              f"({load_grid(engine, 1 << 40, 65536)} blocks)")
        worst, calls, wrapped, oracle_ok = 0, 0, 0, 0
        cases = load_fleets(engine)
        for label, (plane, fleet) in cases.items():
            args = (fleet.packed, fleet.table, fleet.state)
            sizes = load_sizes(engine, fleet.table.numel())
            if max(sizes) > keys.numel():
                fail(f"route_load[{engine}]'s resident pass ({max(sizes)} keys) outgrew the checks' keys")
            bare = kernels.route(keys[:max(sizes)], *args)
            expect = np.asarray(oracle(engine, "route", plane, keys[:N_ORACLE], None))
            for shift in LOAD_SHIFTS:
                for size in sizes:
                    k = keys[:size]
                    start = near_wrap(rng, fleet.table.numel())
                    want_reps, want = kernels.route_load_plain(k, *args, start, 16, shift)
                    counts = start.clone()
                    before = kernels.launches["route_load"]
                    reps, got = kernels.route_load(k, *args, counts, 16, shift)
                    torch.cuda.synchronize()
                    err = max(u32_err(reps, want_reps), u32_err(reps, bare[:size]), u32_err(got, want))
                    worst = max(worst, err)
                    calls += 1
                    wrapped += int(((got.to(torch.int64) & 0xFFFFFFFF)
                                    < (start.to(torch.int64) & 0xFFFFFFFF)).sum())
                    if err or got is not counts or kernels.launches["route_load"] - before != 1:
                        fail(f"route_load[{engine}] on fleet {label}, shift {shift}, {size} keys: "
                             f"max |kernel - plain| = {err}, "
                             f"{kernels.launches['route_load'] - before} launches")
                    if size == N_CHECK:
                        oracle_ok += int((reps[:N_ORACLE].cpu().numpy() == expect).all())
        max_err[engine, "route_load"] = worst
        print(f"phase 2 route_load[{engine}]: {len(cases)} fleets (capacity 64 to 2^20, and 4,096 / "
              f"4,097 either side of the shared histogram's {SHARED_BINS} bins) x shifts {LOAD_SHIFTS} x "
              f"{', '.join(map(str, LOAD_SIZES))} keys and a resident pass (and one key more) from "
              f"accumulators within 2^10 of 2^32: {calls} calls of one launch each, max |kernel - plain| "
              f"= {worst} (replicas against route and the plain version, counts against the plain "
              f"version), {wrapped} bins wrapped, scalar oracle agrees on "
              f"{oracle_ok}/{len(cases) * len(LOAD_SHIFTS)}")
        if oracle_ok != len(cases) * len(LOAD_SHIFTS) or not wrapped:
            fail(f"route_load[{engine}] disagrees with the scalar oracle or never wrapped")


#: replication factors past resolve's register columns (MAX_R = 8), and
#: their fleets: n_alive above and below r
WIDE_RS = (9, 16, 17, 32, 33, 64)
WIDE_FLEETS = {"40/64": (40, 64, 0), "40/64 10 failed": (40, 64, 10),
               "1000/1024 250 failed": (1000, 1024, 250)}
WIDE_ORACLE = 1024


def phase_placement_wide(max_err: dict) -> None:
    """``route_family`` and ``resolve`` at r = 9 to 64 (``WIDE_RS``: resolve's
    row path, odd and even row strides) on ``WIDE_FLEETS`` at 2^20 keys, with and without ``old``, against
    their plain versions, bit-exact; a 1,024-key sample against
    ``scalar_placement``; every row on min(r, n_alive) distinct shards."""
    from repro_torch.core.registry import make_bulk

    keys = u32_tensor(np.random.default_rng(8), N_CHECK).cuda()
    sample = keys[:WIDE_ORACLE].cpu().numpy().view(np.uint32).tolist()
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        report = []
        for label, (n, cap, n_fail) in WIDE_FLEETS.items():
            plane, fleet = make_fleet(engine, n, cap, n_fail, 9)
            _, old = make_fleet(engine, n, cap, 0, 9)
            for r in WIDE_RS:
                prev = kernels.resolve(keys, kernels.route_family(keys, r, old.packed, old.table,
                                                                  old.state), old.table, old.state, r)[0]
                errs = []
                for with_old in (None, prev):
                    (rep, exhausted, moved), e_route, e_res, e_place = check_placement(
                        kernels, keys, fleet, r, r, with_old)
                    errs += [e_route, max(e_res, e_place)]
                for kind, err in (("route_family", max(errs[::2])), ("resolve", max(errs[1::2]))):
                    max_err[engine, kind] = max(max_err.get((engine, kind), 0), err)
                host = np.asarray([scalar_placement(plane.domain, k, r, r)[0] for k in sample])
                n_ok = int((rep[:WIDE_ORACLE].cpu().numpy() == host).all(1).sum())
                distinct = int((rep.sort(1).values.diff(1) != 0).sum(1).add(1).min())
                report.append(f"{label} r={r}: {max(errs)}, host {n_ok}/{WIDE_ORACLE}, distinct {distinct}, "
                              f"moved {int(moved.sum())}")
                if max(errs) or n_ok != WIDE_ORACLE or exhausted.any() \
                        or distinct != min(r, plane.domain.alive_count):
                    fail(f"placement[{engine}] on fleet {label} at r = {r} disagrees")
        print(f"phase 2 placement wide[{engine}], {N_CHECK} keys, r > 8 (resolve's row path), with and "
              f"without old; max |kernel - plain|: " + "; ".join(report))


#: the row path's edges: ragged sizes around a warp's round of 32 keys, r
#: past the registers with odd and even strides, and two r whose rows do not
#: fit: ``ROWS_UNFIT_R``'s 32 rows outgrow a block's shared memory (a warp
#: takes fewer keys), and ``ROWS_OUT_R``'s one row with ``old`` does (the
#: rows are staged in the output); both only at ``max_resalt`` 0 and 1 and
#: small sizes, as the plain version runs a Python loop a column and probe
ROWS_EDGE_RS = (9, 16, 17, 32, 33, 64)
ROWS_EDGE_SIZES = (1, 31, 32, 33, 257, 4097)
ROWS_EDGE_FLEETS = {"1000/1024 250 failed": (1000, 1024, 250), "3/64 1 failed": (3, 64, 1)}
ROWS_UNFIT_R = 2000
ROWS_OUT_R = 30000


def rows_shape(r: int, with_old: bool, n: int) -> tuple:
    """resolve_rows_kernel's launch for r columns over n keys, from the
    library: (keys a warp, warps a block, row stride, grid); stride 0 =
    rows staged in the output."""
    import ctypes

    from repro_torch.kernels import build

    out = (ctypes.c_int * 4)()
    rc = build.library().routing_resolve_rows_shape(r, int(with_old), n, out)
    if rc:
        fail(f"routing_resolve_rows_shape({r}, {with_old}, {n}) failed ({rc})")
    return tuple(out)


def check_rows_launch(kernels, keys, base, fleet, max_resalt: int, old) -> int:
    """One row-path resolve against its plain version, with its one launch's
    logged (grid, keys a warp) held to ``rows_shape`` -> max |kernel - plain|."""
    from repro_torch.analysis.sass_gate import clear_launches, take_launches

    r = base.shape[1]
    per_warp, _, _, grid = rows_shape(r, old is not None, keys.numel())
    clear_launches()
    got = kernels.resolve(keys, base, fleet.table, fleet.state, max_resalt, old)
    shapes = take_launches()
    want = kernels.resolve_plain(keys, base, fleet.table, fleet.state, max_resalt, old)
    torch.cuda.synchronize()
    if shapes != [(grid, per_warp)]:
        fail(f"resolve at r = {r}, {keys.numel()} keys launched {shapes}, not [({grid}, {per_warp})]")
    return max(u32_err(g.to(torch.int32), w.to(torch.int32)) for g, w in zip(got, want)
               if g is not None)


def phase_rows_edges(max_err: dict) -> None:
    """resolve's row path at its edges, against the plain version bit for
    bit, each call one launch of the shape ``rows_shape`` gives: r in
    ``ROWS_EDGE_RS`` x ``ROWS_EDGE_SIZES`` x ``ROWS_EDGE_FLEETS`` (n_alive
    above r, and below it) x ``max_resalt`` r, 0 and 1, with and without
    ``old``; ``ROWS_UNFIT_R`` (fewer keys a warp) at 1, 33 and 257 keys and
    ``ROWS_OUT_R`` (with ``old`` staged in the output) at 33 keys, on the
    first fleet.  resolve is one function for both engines, so it runs on
    the binomial engine's kernels."""
    from repro_torch.core.registry import make_bulk

    kernels = make_bulk("binomial").kernels
    keys = u32_tensor(np.random.default_rng(12), max(ROWS_EDGE_SIZES)).cuda()
    worst, calls = 0, 0
    t0 = time.perf_counter()
    for label, (n, cap, n_fail) in ROWS_EDGE_FLEETS.items():
        _, fleet = make_fleet("binomial", n, cap, n_fail, 13)
        _, healthy = make_fleet("binomial", n, cap, 0, 13)
        cases = [(r, size, mr) for r in ROWS_EDGE_RS for size in ROWS_EDGE_SIZES for mr in (r, 0, 1)]
        if label == "1000/1024 250 failed":
            cases += [(ROWS_UNFIT_R, size, mr) for size in (1, 33, 257) for mr in (0, 1)]
            cases += [(ROWS_OUT_R, 33, 0)]
        for r, size, mr in cases:
            k = keys[:size]
            base = kernels.route_family(k, r, fleet.packed, fleet.table, fleet.state)
            prev = kernels.resolve(k, kernels.route_family(k, r, healthy.packed, healthy.table,
                                                           healthy.state), healthy.table,
                                   healthy.state, 0)[0]
            for old in (None, prev):
                err = check_rows_launch(kernels, k, base, fleet, mr, old)
                worst, calls = max(worst, err), calls + 1
                if err:
                    fail(f"resolve's row path at r = {r}, {size} keys, max_resalt {mr}, fleet {label}"
                         f"{'' if old is None else ' with old'}: max |kernel - plain| = {err}")
    for engine in ENGINES:
        max_err[engine, "resolve"] = max(max_err.get((engine, "resolve"), 0), worst)
    shapes = {f"r={r}{' old' if o else ''}": rows_shape(r, o, N_CHECK)
              for r in (16, 64, ROWS_UNFIT_R, ROWS_OUT_R) for o in (False, True)}
    print(f"phase 2 resolve row path edges: r {ROWS_EDGE_RS} x {ROWS_EDGE_SIZES} keys x "
          f"max_resalt r/0/1 x fleets {list(ROWS_EDGE_FLEETS)}, r = {ROWS_UNFIT_R} and {ROWS_OUT_R}, "
          f"with and without old: {calls} calls of one launch each, max |kernel - plain| = {worst}; "
          f"launch at {N_CHECK} keys (keys a warp, warps a block, stride, grid) {shapes}; "
          f"{time.perf_counter() - t0:.1f} s")
    if shapes[f"r={ROWS_UNFIT_R}"][0] >= 32 or shapes[f"r={ROWS_OUT_R} old"][2] != 0:
        fail("the row path's unfit r did not take its smaller rounds or the output")


# --- the chain-mode remap ---------------------------------------------------

#: failed shares of the chain checks and times: the JAX package's severity
#: sweep (0, 6, 25, 50 %), at 1000 of 1024 slots
CHAIN_SHARES = (0.0, 0.06, 0.25, 0.5)
#: max_chain checked: no step (every removed lane takes first_alive), one
#: step, two and eight (walks run out inside refilled lanes), and the default
CHAIN_MAX = (0, 1, 2, 8, 4096)
#: (n, capacity, failed, seed): the seven fleets of the route checks, then
#: the sweep's other shares and 90 % failed (long walks)
CHAIN_FLEETS = {
    "1000/1024 healthy": (1000, 1024, 0, 1), "1000/1024 250 failed": (1000, 1024, 250, 2),
    "40000/65536 25% failed": (40000, 65536, 10000, 3), "n=1": (1, 64, 0, 4),
    "n=1023": (1023, 2048, 0, 5), "n=1024": (1024, 2048, 0, 6),
    "n=1025 3 failed": (1025, 2048, 3, 7), "1000/1024 6% failed": (1000, 1024, 60, 8),
    "1000/1024 50% failed": (1000, 1024, 500, 9), "1000/1024 90% failed": (1000, 1024, 900, 10),
}


#: keys a block of chain_remap takes in one chunk per warp (routing.cu's
#: THREADS x MAX_ITEMS)
CHAIN_BLOCK_KEYS = 256 * 8


def chain_pass() -> int:
    """Keys one pass of chain_remap's resident grid takes: every warp one
    chunk of 32 x MAX_ITEMS keys.  Past it a warp walks several chunks and
    its ring of removed keys carries from one to the next."""
    from repro_torch.kernels import build

    return build.library().routing_chain_grid(1 << 40) * CHAIN_BLOCK_KEYS


def chain_sizes() -> tuple:
    """The chain checks' key counts: around a warp and a chunk
    (``TAIL_SIZES``), 2^20, and around the ring's carry-over: one key past
    a pass (one warp takes a second chunk of one key), a ragged second
    chunk, two passes less one, three passes and a ragged chunk."""
    r = chain_pass()
    return (*TAIL_SIZES, N_CHECK, r + 1, r + 33, 2 * r - 1, 3 * r + 4097)


def chain_plane(engine: str, n: int, n_fail: int, seed: int, max_chain: int = 4096):
    """A chain-mode control plane (``resolve="chain"``, ``chain_bits=32``:
    the chain remap's scalar oracle) with ``n_fail`` random slots of
    ``[0, n-1)`` failed: the same slots as ``make_fleet`` at that seed."""
    from repro_torch.core.registry import make_bulk
    from repro_torch.serving.router import SessionRouter

    plane = SessionRouter(n, engine=make_bulk(engine).scalar_engine, chain_bits=32,
                          max_chain=max_chain)
    rng = np.random.default_rng(seed)
    for b in rng.choice(max(n - 1, 1), size=n_fail, replace=False):
        plane.fail(int(b))
    return plane


def phase_chain_remap(max_err: dict) -> None:
    """``chain_remap`` (one launch per call) against its plain version on
    the card, bit-exact, over ``CHAIN_FLEETS`` x ``CHAIN_MAX`` at
    ``chain_sizes()``, its base buckets from ``lookup_dyn``; and both
    launches together against the scalar chain oracle
    (``FailureDomain.locate`` of the chain-mode plane) on 4,096 keys."""
    from repro_torch.core.bulk import ChainFleet
    from repro_torch.core.registry import make_bulk

    sizes = chain_sizes()
    rng = np.random.default_rng(5)
    keys = u32_tensor(rng, max(sizes)).cuda()
    sample = keys[:N_ORACLE].cpu().numpy().view(np.uint32)
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        worst, cases = 0, 0
        for label, (n, capacity, n_fail, seed) in CHAIN_FLEETS.items():
            for max_chain in CHAIN_MAX:
                plane = chain_plane(engine, n, n_fail, seed, max_chain)
                chain = ChainFleet.pack(plane.domain, capacity).to("cuda")
                base = kernels.lookup_dyn(keys, chain.state[:1])
                for size in sizes:
                    k, b = keys[:size], base[:size]
                    before = kernels.launches["chain_remap"]
                    got = kernels.chain_remap(k, b, chain.packed, chain.state, max_chain)
                    want = kernels.chain_remap_plain(k, b, chain.packed, chain.state, max_chain)
                    torch.cuda.synchronize()
                    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                    worst = max(worst, err)
                    if err or got.shape != want.shape or \
                            kernels.launches["chain_remap"] - before != 1:
                        fail(f"chain_remap[{engine}] on {label}, max_chain {max_chain}, {size} "
                             "keys disagrees with its plain version or launched other than once")
                expect = [plane.domain.locate(int(x)) for x in sample]
                if got[:N_ORACLE].cpu().numpy().tolist() != expect:
                    fail(f"lookup_dyn + chain_remap[{engine}] on {label}, max_chain {max_chain} "
                         "disagrees with the scalar chain oracle")
                cases += 1
        max_err[engine, "chain_remap"] = worst
        print(f"phase 2 chain_remap[{engine}]: {cases} cases ({len(CHAIN_FLEETS)} fleets: "
              f"{', '.join(CHAIN_FLEETS)}; x max_chain {CHAIN_MAX}) at "
              f"{', '.join(map(str, sizes))} keys (a pass of the resident grid: "
              f"{chain_pass()} keys): max |kernel - plain| = {worst}, one launch per call; "
              f"lookup_dyn + chain_remap agree with the scalar chain oracle on "
              f"{N_ORACLE}/{N_ORACLE} keys of every case")


# --- the training kernels (csrc/train.cu) -------------------------------------

TRAIN_SRC = "src/repro_torch/kernels/csrc/train.cu"
TRAIN_KINDS = ("adamw_update", "radix_hist", "radix_pick")
#: the functions the training kernels compute in the JAX package (neither
#: is a pallas_call there)
TRAIN_REPLACES = {
    "adamw_update": "src/repro/training/optimizer.py:63 (AdamW.update: jnp in the JAX package, "
                    "no pallas_call)",
    "radix_hist": "src/repro/training/compression.py:43 (compress_topk's threshold: "
                  "jax.lax.top_k in the JAX package, no pallas_call)",
    "radix_pick": "src/repro/training/compression.py:43 (compress_topk's threshold: "
                  "jax.lax.top_k in the JAX package, no pallas_call)",
}
#: phase 2's AdamW size: one plain slice (2^26) and a ragged tail past it
ADAMW_CHECK = (1 << 26) + 12_345
#: element offsets of the operands into their storage: aligned, one offset
#: for all (a scalar head), offsets no index aligns together (all scalar)
ADAMW_OFFSETS = {"aligned": (0, 0), "offset 3": (3, 3), "mixed 1/2": (1, 2)}
#: the select's check sizes: 2^20 with ties, and the largest leaf of the
#: full-width train cell, experts_wi (128 experts x 4096 x 1536)
SELECT_CHECK = 1 << 20
EXPERTS_WI = 128 * 4096 * 1536
#: topk compression's share kept (compression.compress_topk's frac)
TOPK_FRAC = 0.05


def bits_of(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bit patterns differ."""
    return int((bits_of(a) != bits_of(b)).sum())


def adamw_operands(n: int, gdtype, pdtype, master: bool, offsets, seed: int) -> dict:
    """Seeded AdamW operands on the card, each a view ``offsets`` elements
    into its own storage (the gradient and parameter at the first offset,
    the float32 state at the second), the gradient's first elements zeros,
    a signed zero, a subnormal and a large value; the step's scalars."""
    gen = torch.Generator("cuda").manual_seed(seed)
    og, om = offsets

    def operand(sd, dtype, off):
        return (torch.randn(n + off, generator=gen, device="cuda") * sd).to(dtype)[off:]

    g = operand(2.0, gdtype, og)
    g[:4] = torch.tensor([0.0, -0.0, 1e-40, 7e15], device="cuda").to(gdtype)
    lr = torch.tensor(1e-3, device="cuda")
    return dict(g=g, m=operand(0.1, torch.float32, om), v=operand(0.1, torch.float32, om).abs_(),
                ref=operand(0.5, torch.float32, om) if master else None,
                p=operand(0.5, pdtype, og), lr=lr, c1=torch.tensor(0.19, device="cuda"),
                c2=torch.tensor(0.0975, device="cuda"), lr_wd=lr * torch.tensor(0.1, device="cuda"))


def select_inputs() -> dict:
    """The select's check inputs on the card: 2^20 values with ties, the
    edge cases (NaN above inf, signed zeros, subnormals), a view that does
    not start on a 16-byte boundary, and a gradient-like leaf of
    experts_wi's size."""
    rng = np.random.default_rng(42)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1e-39,
                        3.4e38, -3.4e38, 1.0, -1.0, 1.0, 0.5, 2.0, 7.0], np.float32)
    zeros = np.zeros(1000, np.float32)
    zeros[::3] = -0.0
    host = {
        "ties 2^20": (rng.integers(-400, 400, size=SELECT_CHECK) / 8).astype(np.float32),
        "special": special,
        "subnormal": (rng.integers(1, 1 << 23, size=4099) * np.float32(1e-45)).astype(np.float32),
        "signed zeros": zeros,
        "unaligned view": rng.normal(size=SELECT_CHECK + 7).astype(np.float32),
    }
    out = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    out["unaligned view"] = out["unaligned view"][1:]
    gen = torch.Generator("cuda").manual_seed(43)
    out["experts_wi"] = torch.randn(EXPERTS_WI, generator=gen, device="cuda") * 1e-4
    return out


def phase_train_kernels(max_err: dict) -> None:
    """The training kernels against their plain versions on the card, bit
    for bit: ``adamw_update`` over every case it takes (gradient bf16 /
    float32 x parameter bf16 / float32 x master weights on / off x the
    clip's scale or none) at ``ADAMW_CHECK`` elements, aligned, at one
    offset and at offsets no index aligns; the select (``radix_select``:
    three ``radix_hist`` + ``radix_pick`` rounds) against ``torch.topk``'s
    k-th value and the plain rounds, each round's histogram and choice
    against the plain ones, at k = 1, a twentieth, a half and numel."""
    import itertools

    from repro_torch.kernels import train as T

    dtypes = (torch.bfloat16, torch.float32)
    cases = differ = 0
    for (label, offsets), gdtype, pdtype, master, scaled in itertools.product(
            ADAMW_OFFSETS.items(), dtypes, dtypes, (True, False), (False, True)):
        ops_ = adamw_operands(ADAMW_CHECK, gdtype, pdtype, master, offsets, 50 + cases)
        scale = torch.tensor(0.37, device="cuda") if scaled else None
        kernel = {k: ops_[k] for k in ("m", "v", "ref", "p")}
        plain = {k: None if t is None else t.clone() for k, t in kernel.items()}
        args = (ops_["lr"], ops_["c1"], ops_["c2"], ops_["lr_wd"], scale)
        before = T.launches["adamw_update"]
        T.adamw_update(ops_["g"], kernel["m"], kernel["v"], kernel["ref"], kernel["p"], *args,
                       b1=0.9, b2=0.95, eps=1e-8)
        T.adamw_update_plain(ops_["g"], plain["m"], plain["v"], plain["ref"], plain["p"], *args,
                             b1=0.9, b2=0.95, eps=1e-8)
        torch.cuda.synchronize()
        if T.launches["adamw_update"] != before + 1:
            fail("adamw_update launched other than once")
        bad = {k: differing(kernel[k], plain[k]) for k in kernel if kernel[k] is not None}
        if any(bad.values()):
            fail(f"adamw_update ({label}, g {gdtype}, p {pdtype}, master {master}, scale "
                 f"{scaled}) differs from its plain version in {bad} elements")
        differ += sum(bad.values())
        cases += 1
        del ops_, kernel, plain
    max_err["adamw_update"] = differ
    print(f"phase 2 adamw_update: {cases} cases (gradient bf16/float32 x parameter bf16/float32 "
          f"x master weights on/off x clip scale 0.37/none x offsets {list(ADAMW_OFFSETS)}) at "
          f"{ADAMW_CHECK:,} elements: 0 differing elements in m, v, master and parameter against "
          f"the plain version, one launch a call")
    rounds = selects = 0
    for label, x in select_inputs().items():
        n = x.numel()
        # experts_wi at the train path's k (torch.topk at k = numel there
        # would sort 0.8 G elements); the smaller inputs up to k = numel
        ks = {1, max(1, int(n * TOPK_FRAC))} if n == EXPERTS_WI else {
            1, max(1, n // 20), max(1, n // 2), n}
        for k in sorted(ks):
            before = dict(T.launches)
            got = T.radix_select(x, k)
            if (T.launches["radix_hist"], T.launches["radix_pick"]) != (
                    before["radix_hist"] + 3, before["radix_pick"] + 3):
                fail("the select launched other than three rounds of radix_hist and radix_pick")
            want = torch.topk(x.abs(), k).values[-1]
            plain = T.radix_select_plain(x, k)
            if not int(bits_of(got)) == int(bits_of(want)) == int(bits_of(plain)):
                fail(f"the select on {label} at k = {k}: {float(got)!r} against torch.topk's "
                     f"{float(want)!r} and the plain rounds' {float(plain)!r}")
            selects += 1
        prefix = torch.zeros(1, dtype=torch.int32, device="cuda")
        sought = torch.full((1,), max(1, int(n * TOPK_FRAC)), dtype=torch.int64, device="cuda")
        for shift, width in T.RADIX_ROUNDS:
            hist = T.radix_hist(x, prefix, shift, width)
            if not torch.equal(hist, T.radix_hist_plain(x, prefix, shift, width)):
                fail(f"radix_hist on {label}, digit at {shift}: counts differ from the plain ones")
            s2, p2 = sought.clone(), prefix.clone()
            T.radix_pick_plain(hist, s2, p2, shift)
            T.radix_pick(hist, sought, prefix, shift)
            if not (torch.equal(sought, s2) and torch.equal(prefix, p2)):
                fail(f"radix_pick on {label}, digit at {shift}: differs from the plain choice")
            rounds += 1
        del x
    max_err["radix_hist"] = max_err["radix_pick"] = 0
    print(f"phase 2 radix select: {selects} selects (ties at 2^20, NaN/inf/signed zeros, "
          f"subnormals, an unaligned view: k = 1, n/20, n/2, n; experts_wi's {EXPERTS_WI:,} "
          f"gradient-like values: k = 1, {int(EXPERTS_WI * TOPK_FRAC):,}) equal to torch.topk's "
          f"k-th value and the plain rounds bit for "
          f"bit, three launches of each kernel a select; {rounds} rounds' histograms and choices "
          f"equal to the plain ones")


# --- the main path ----------------------------------------------------------


def phase_router() -> dict:
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.kernels import ops
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
    # the bulk static-n lookup, through the entry point each engine has
    for engine in ENGINES:
        kernels = BULK_ENGINES[engine].kernels
        for n in (VEC_N_TIME, VEC_N_HALF):
            got = (ops.binomial_bulk_lookup(keys, n) if engine == "binomial"
                   else kernels.lookup_vec(keys, n))
            want = kernels.lookup_vec_plain(keys.cpu(), n)
            if not (got.is_cuda and torch.equal(got.cpu(), want)):
                fail(f"bulk lookup_vec[{engine}] at n = {n} differs from the plain version")
        print(f"phase 3 bulk lookup_vec[{engine}] on {N_CHECK} keys, n = {VEC_N_TIME} and "
              f"{VEC_N_HALF}: bit-exact with the plain version on the CPU")
    torch.cuda.synchronize()
    launches = {(e, k): BULK_ENGINES[e].kernels.launches[k] for e in ENGINES for k in KINDS}
    print("phase 3 router launches " + json.dumps({f"{k}[{e}]": n for (e, k), n in launches.items()}))
    missing = [f"{k}[{e}]" for (e, k), n in launches.items() if n == 0]
    if missing:
        fail(f"the router path never launched {missing}")
    return launches


def phase_chain_path() -> dict:
    """The chain-mode two-pass path through its entry point
    (``ops.route_chain_bulk``: ``lookup_dyn``, then ``chain_remap``), per
    engine, over a chain-mode control plane of 1000 replicas (capacity
    1024) through fleet events: healthy, 6 %, 25 % and 50 % failed, 100
    recovered, a scale-up and a scale-down, the ``ChainFleet`` packed and
    uploaded once per event.  At each state 2^20 keys on the card,
    bit-exact with the plain versions and with the scalar oracle on 4,096
    keys; each call launches lookup_dyn and chain_remap once."""
    from repro_torch.core.bulk import ChainFleet, RouterSpec
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.kernels import ops

    for eng in BULK_ENGINES.values():
        eng.kernels.reset_launches()
    rng = np.random.default_rng(6)
    keys = u32_tensor(rng, N_CHECK).cuda()
    sample = keys[:N_ORACLE].cpu().numpy().view(np.uint32)
    calls = {}
    for engine in ENGINES:
        kernels = BULK_ENGINES[engine].kernels
        spec = RouterSpec(engine, 1024)
        plane = chain_plane(engine, 1000, 0, 0)
        order = [int(b) for b in rng.permutation(999)]
        steps = [("healthy", lambda: None)]
        for frac in CHAIN_SHARES[1:]:
            def fail_to(frac=frac):
                for b in order[len(plane.domain.removed):int(frac * 1000)]:
                    plane.fail(b)
            steps.append((f"{frac:.0%} failed", fail_to))
        steps += [("100 recovered", lambda: [plane.recover(b) for b in order[:100]]),
                  ("scale up", plane.scale_up), ("scale down", plane.scale_down)]
        for label, event in steps:
            event()
            chain = ChainFleet.pack(plane.domain, spec.capacity).to("cuda")
            got = ops.route_chain_bulk(keys, chain, spec)
            base = kernels.lookup_dyn_plain(keys, chain.state[:1])
            want = kernels.chain_remap_plain(keys, base, chain.packed, chain.state)
            if not (got.is_cuda and torch.equal(got, want)):
                fail(f"chain path[{engine}] at {label} differs from the plain versions")
            if got[:N_ORACLE].cpu().numpy().tolist() != [plane.domain.locate(int(x))
                                                         for x in sample]:
                fail(f"chain path[{engine}] at {label} differs from the scalar chain oracle")
        calls[engine] = len(steps)
        print(f"phase 3 chain path[{engine}]: ops.route_chain_bulk on {N_CHECK} keys over "
              f"{', '.join(label for label, _ in steps)}: bit-exact with the plain versions and "
              f"the scalar chain oracle ({N_ORACLE} keys) at every state")
    torch.cuda.synchronize()
    launches = {(e, k): n for e in ENGINES for k, n in BULK_ENGINES[e].kernels.launches.items()}
    print("phase 3 chain path launches " + json.dumps(
        {f"{k}[{e}]": n for (e, k), n in launches.items() if n}))
    for engine in ENGINES:
        ran = {k: n for (e, k), n in launches.items() if e == engine and n}
        if ran != {"lookup_dyn": calls[engine], "chain_remap": calls[engine]}:
            fail(f"the chain path[{engine}] launched {ran}, expected lookup_dyn and chain_remap "
                 f"{calls[engine]} times each")
    return {key: n for key, n in launches.items() if n}


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
    """``cfg`` with its MoE layers on the hash router of ``engine`` (a dense
    model is returned as it is)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="hash", router_hash_engine=engine, router_hash_omega=16))


def make_requests(vocab: int, seed: int, prompt: int = SERVE_PROMPT):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(f"session-{i}", rng.integers(0, vocab, size=prompt).astype(np.int32),
                    SERVE_NEW) for i in range(SERVE_REQUESTS)]


def check_answers(tag, out, reqs, vocab: int) -> None:
    if sorted(out) != sorted(r.session_id for r in reqs):
        fail(f"{tag}: not every request was answered")
    for r in reqs:
        row = out[r.session_id]
        if row.shape != (r.n_new,) or row.min() < 0 or row.max() >= vocab:
            fail(f"{tag}: {r.session_id} got {row!r}")


def check_small_model(arch: str, prompt: int = SERVE_PROMPT) -> None:
    """The reduced (hash-routed, where it has MoE layers) model of ``arch``
    served on the card (float32) against the same tier on the CPU, which
    runs the plain versions, with prompts of ``prompt`` tokens: the same
    tokens, and prefill logits within ``SMALL_LOGIT_TOL``."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingTier

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    for engine in ENGINES:
        cfg = hash_routed(reduced_config(arch), engine)
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        reqs = make_requests(cfg.vocab_size, 7, prompt)
        max_len = prompt + SERVE_NEW + 2
        tiers = [ServingTier(cfg, p, SERVE_REPLICAS, max_len=max_len, engine=engine, device=d)
                 for p, d in ((M.params_to(params, "cuda"), "cuda"), (params, "cpu"))]
        outs = [t.serve(reqs) for t in tiers]
        check_answers(f"reduced serve[{engine}]", outs[0], reqs, cfg.padded_vocab)
        same = all(np.array_equal(outs[0][r.session_id], outs[1][r.session_id]) for r in reqs)
        prompts = torch.from_numpy(np.stack([r.prompt for r in reqs]))
        logits = [M.prefill(t.replicas[0].params, {"tokens": prompts.to(t.device)}, cfg,
                            max_len)[1].cpu() for t in tiers]
        err = float((logits[0] - logits[1]).abs().max())
        print(f"phase 3 reduced serve {arch}[{engine}] ({cfg.num_layers} layers "
              f"{'/'.join(sorted(set(cfg.layer_kinds())))}, d_model {cfg.d_model}, "
              f"{cfg.attention}, window {cfg.window}, prompts of {prompt}, float32): card vs CPU tokens "
              f"{'identical' if same else 'DIFFER'}, max |logit diff| {err:.3g} (tolerance "
              f"{SMALL_LOGIT_TOL})")
        if not same or not err <= SMALL_LOGIT_TOL:
            fail(f"the reduced serve {arch}[{engine}] on the card disagrees with the CPU")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def profile_serve(tag: str, tier, reqs, n_steps: int, step_floor_ms: float, card: str) -> None:
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
    events = prof.key_averages()
    n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"phase 3 {tag} profiled serve() call: the profiler recorded no "
              f"device time (wall {wall_ms:.1f} ms)")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"phase 3 {tag} profiled serve() call: wall {wall_ms:.1f} ms for {n_steps} "
          f"steps, {n_ops} torch operators ({n_ops / n_steps:.0f} per step), "
          f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}; floor "
          f"{n_steps * step_floor_ms:.1f} ms) on {card}; top kernels by device time: "
          + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                      for e in top))


def aten_ops(fn) -> dict[str, int]:
    """The torch operators one call of ``fn`` dispatches, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")}


#: operators that allocate or view but compute nothing (the router call
#: allocates its output and gates too)
ALLOCATING_OPS = {"aten::empty", "aten::empty_strided", "aten::empty_like", "aten::resize_",
                  "aten::as_strided", "aten::unsqueeze", "aten::view", "aten::expand"}


def check_router_call(cfg, engine: str) -> None:
    """One hash-router call of ``moe.route`` at a prefill group's shape:
    one lookup_vec launch and none of the operators that building the
    keys with torch (``router_keys``) dispatches."""
    from repro_torch.core.binomial_torch import router_keys
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.models.layers import moe

    kernels = BULK_ENGINES[engine].kernels
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, size=(16, SERVE_PROMPT))).cuda()
    x = torch.zeros((*tokens.shape, cfg.d_model), dtype=torch.bfloat16, device="cuda")
    moe.route(None, x, tokens, 3, cfg)  # warm
    before = kernels.launches["lookup_vec"]
    route_ops = aten_ops(lambda: moe.route(None, x, tokens, 3, cfg))
    launched = kernels.launches["lookup_vec"] - before
    key_ops = {op: n for op, n in aten_ops(lambda: router_keys(tokens, 3, cfg.moe.top_k)).items()
               if op not in ALLOCATING_OPS}
    shared = sorted(set(route_ops) & set(key_ops))
    print(f"phase 3 serve[{engine}] one moe.route call (tokens {tuple(tokens.shape)}): "
          f"{launched} launch (lookup_router, counted under lookup_vec), torch operators "
          f"{json.dumps(route_ops)}; building the "
          f"keys with torch computes with {sum(key_ops.values())} ({', '.join(sorted(key_ops))}), "
          f"of which the call runs {shared or 'none'}")
    if launched != 1 or shared:
        fail(f"serve[{engine}]: the router call made {launched} launches and ran the key "
             f"build's operators {shared}")


def check_dynamic_router(cfg, engine: str) -> None:
    """``moe.route`` with ``router_dynamic_n`` (keys built with torch, n
    read on the device by lookup_dyn) against the default call at the serve
    path's router shapes: identical expert ids, and one lookup_dyn launch
    per call."""
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.models.layers import moe

    kernels = BULK_ENGINES[engine].kernels
    dynamic = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_dynamic_n=True))
    rng = np.random.default_rng(14)
    for shape in ((16, SERVE_PROMPT), (16, 1)):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape)).cuda()
        x = torch.zeros((*shape, cfg.d_model), dtype=torch.bfloat16, device=tokens.device)
        for salt in (0, 3):
            before = kernels.launches["lookup_dyn"]
            got = moe.route(None, x, tokens, salt, dynamic)[0]
            launched = kernels.launches["lookup_dyn"] - before
            want = moe.route(None, x, tokens, salt, cfg)[0]
            if launched != 1 or got.shape != want.shape or not torch.equal(got, want):
                fail(f"serve[{engine}]: the dynamic-n router call at tokens {shape}, layer {salt} "
                     f"made {launched} lookup_dyn launches or gave other expert ids")
    print(f"phase 3 serve[{engine}] moe.route with router_dynamic_n at tokens (16, {SERVE_PROMPT}) "
          f"and (16, 1), layers 0 and 3: one lookup_dyn launch per call, expert ids identical "
          f"to the default call's (lookup_router)")


def init_full_width(base, card: str, what: str, reckoned: str):
    """Random bf16 weights of ``base`` on the card from a seeded generator
    -> (params, bytes held, the floor of one model step in ms)."""
    from repro_torch.models import model as M

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator("cuda").manual_seed(0), hash_routed(base, "binomial"))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    held = tree_bytes(params)
    step_floor_ms = floor_bytes(base, params) / hw.HBM_BW * 1e3
    print(f"phase 3 {what}: random weights in {init_s:.2f} s; parameters {held / 1e9:.3f} GB "
          f"(reckoned: {reckoned}); init peak {init_peak / 1e9:.3f} GB on {card}")
    return params, held, step_floor_ms


def serve_engines(tag: str, base, params, held: int, step_floor_ms: float, card: str,
                  extra=None, profiled=ENGINES) -> tuple[dict, dict]:
    """``ServingTier`` over ``params`` with the hash router, per engine:
    ``SERVE_REQUESTS`` requests before and after replica ``SERVE_FAIL``
    fails, the launch counts set to 0 just before and read just after;
    every request answered, only the failed replica's sessions moved,
    ``lookup_router`` launched MoE layers x (1 + new tokens) x groups times
    with every expert id equal to the plain lookup's, route twice; then
    ``extra(cfg, engine)`` and, for the engines in ``profiled``, one
    profiled call.  -> (launches, the
    largest router call's token ids and layer salt, by phase and engine)."""
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.serving.engine import ServingTier

    n_moe = sum(k == "attn_moe" for k in base.layer_kinds())
    launches, calls_seen = {}, {"prefill": {}, "decode": {}}
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
                check_answers(f"{tag}[{engine}]", out, reqs, cfg.padded_vocab)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # moe.route's static-n lookup is lookup_router, whose launches the
        # wrapper counts under lookup_vec; no other lookup_vec runs here
        launches[engine] = {"route": kernels.launches["route"],
                            "lookup_router": kernels.launches["lookup_vec"]}
        after = [tier.router.route(i) for i in ids]
        moved = [i for i, a, b in zip(ids, before, after) if a != b]
        if any(b != SERVE_FAIL for i, a, b in zip(ids, after, before) if a != b) \
                or SERVE_FAIL in after:
            fail(f"{tag}[{engine}]: sessions moved that were not on replica {SERVE_FAIL}")
        want = n_moe * (1 + SERVE_NEW) * groups
        if launches[engine]["lookup_router"] != want or launches[engine]["route"] != 2:
            fail(f"{tag}[{engine}]: launches {launches[engine]}, expected lookup_router = "
                 f"{n_moe} MoE layers x (1 + {SERVE_NEW}) x {groups} groups = {want}, route = 2")
        if len(log.calls) != want:
            fail(f"{tag}[{engine}]: {len(log.calls)} router calls for {want} launches")
        m = cfg.moe
        for salt, tokens, expert_ids in log.calls:
            plain = kernels.lookup_router_plain(tokens, salt, m.top_k, m.num_experts,
                                                m.router_hash_omega)
            if not torch.equal(expert_ids, plain):
                fail(f"{tag}[{engine}]: the expert ids of layer {salt} differ from the plain "
                     "lookup's")
            phase = "prefill" if tokens.shape[1] > 1 else "decode"
            if tokens.numel() > calls_seen[phase].get(engine, (torch.empty(0), 0))[0].numel():
                calls_seen[phase][engine] = (tokens, salt)
        tokens_out = SERVE_REQUESTS * SERVE_NEW
        print(f"phase 3 {tag}[{engine}]: {SERVE_REQUESTS} requests x {SERVE_NEW} new tokens on "
              f"{SERVE_REPLICAS} replicas, all answered; fail({SERVE_FAIL}) moved "
              f"{len(moved)}/{len(ids)} sessions, all from replica {SERVE_FAIL}; "
              f"{len(log.calls)} router calls, every expert id equal to the plain lookup's")
        print(f"phase 3 {tag}[{engine}] launches " + json.dumps(
            {f"{k}[{engine}]": n for k, n in launches[engine].items()})
            + f" (lookup_router = {n_moe} MoE layers x (1 + {SERVE_NEW}) x {groups} groups)")
        print(f"phase 3 {tag}[{engine}] wall per serve() call: "
              + ", ".join(f"{w * 1e3:.1f} ms ({tokens_out / w:.1f} new tokens/s; {n} model steps, "
                          f"{w * 1e3 / n:.2f} ms per step)" for w, n in zip(walls, steps))
              + f" [first call, then after the failure]; floor per step {step_floor_ms:.2f} ms "
              f"(every weight read once, the input embedding table only where it is the "
              f"unembedding, at {hw.HBM_BW / 1e12} TB/s); "
              f"peak memory {peak / 1e9:.3f} GB (parameters {held / 1e9:.3f} GB) on {card}")
        if extra is not None:
            extra(cfg, engine)
        if engine in profiled:
            profile_serve(f"{tag}[{engine}]", tier, reqs, steps[-1], step_floor_ms, card)
    return launches, calls_seen


def check_full_width_logits(base, params) -> None:
    from repro_torch.models import model as M

    probe = make_requests(base.vocab_size, 12)[:2]
    prompts = torch.from_numpy(np.stack([r.prompt for r in probe])).cuda()
    _, logits = M.prefill(params, {"tokens": prompts}, hash_routed(base, "binomial"), 18)
    if logits.shape != (2, base.padded_vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"{base.name} full-width prefill logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")


def phase_serve(card: str, mesh) -> tuple[dict, dict, dict]:
    """ServingTier at full width, Qwen3-235B-A22B, then phase "mesh" part
    (c) over the same weights: -> (launches, the largest router call's
    token ids and layer salt, by phase and engine; part (c)'s launches)."""
    from repro_torch.configs import get_config

    check_small_model(SERVE_ARCH)
    base = dataclasses.replace(get_config(SERVE_ARCH), num_layers=SERVE_LAYERS)
    params, held, step_floor_ms = init_full_width(
        base, card,
        f"serve model: {SERVE_ARCH} at its published widths (d_model {base.d_model}, "
        f"{base.num_heads}/{base.num_kv_heads} heads of {base.resolved_head_dim}, "
        f"{base.moe.num_experts} experts top-{base.moe.top_k} of width {base.moe.d_ff_expert}, "
        f"vocab {base.vocab_size} padded to {base.padded_vocab}), {base.dtype}, layers cut "
        f"94 -> {SERVE_LAYERS}",
        "4 x 4.975 GB per layer + 2.491 GB embeddings = 22.39 GB")

    def router_checks(cfg, engine):
        check_router_call(cfg, engine)
        check_dynamic_router(cfg, engine)

    launches, calls_seen = serve_engines("serve", base, params, held, step_floor_ms, card,
                                         router_checks)
    check_full_width_logits(base, params)
    mesh_launches = mesh_serve(card, base, params, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, calls_seen, mesh_launches


# --- phase "mesh": the multi-device serving path ------------------------------

#: the mesh phase's routing batch (2^24 seeded keys) on the serving fleet
#: (1000 replicas of 1024 capacity, 250 failed)
MESH_KEYS = N_TIME
MESH_FLEET = (1000, 1024, 250)
#: part (c): 72-token prompts, so that every replica's prefill takes the
#: expert-parallel body (n_local * top_k >= 72 * 8 = 576 > 4 * 128 experts)
#: and every decode step the dense GShard path (at most 24 tokens: 24 * 8 =
#: 192 <= 512); max_len 82
MESH_PROMPT = 72
#: the bf16 gate on logits, relative L2 (PERF.md §2)
MESH_LOGIT_TOL = 0.1
#: part (b): the float32 EP layer against the same layer unmeshed
MESH_EP_TOL = 1e-5
#: seconds the two ranks of part (b) may take, start-up included
MESH_JOIN_S = 300


def serving_fleet(engine: str, mesh=None, **kw):
    """``BatchRouter`` over the serving fleet (``MESH_FLEET``; the same
    250 failed slots every call), sharded over ``mesh`` when given."""
    from repro_torch.serving.batch_router import BatchRouter

    n, capacity, n_fail = MESH_FLEET
    router = BatchRouter(n, engine=engine, capacity=capacity, mesh=mesh, **kw)
    with router.coalesced_events():
        for b in np.random.default_rng(2).choice(n - 1, size=n_fail, replace=False):
            router.fail(int(b))
    return router


def mesh_keys() -> np.ndarray:
    return np.random.default_rng(23).integers(0, 2**32, size=MESH_KEYS, dtype=np.uint32)


def reset_all_launches() -> None:
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.kernels import train as T

    for eng in BULK_ENGINES.values():
        eng.kernels.reset_launches()
    T.reset_launches()


def mesh_one_rank(card: str, mesh) -> dict:
    """Part (a): the sharded route on a world of one rank over NCCL, both
    engines: ``route_keys`` of a host batch (its block uploaded), of a
    device batch the caller owns (left intact) and with ``donate_keys``
    (the ids written over the router's own upload), each bit-exact with
    the unmeshed router, one route launch each; then the device batch's
    median time in turns with the unmeshed ``route_keys``."""
    from repro_torch.core.registry import BULK_ENGINES

    keys_np = mesh_keys()
    keys = torch.from_numpy(keys_np.view(np.int32)).cuda()
    launches = {}
    for engine in ENGINES:
        kernels = BULK_ENGINES[engine].kernels
        sharded, donating = serving_fleet(engine, mesh), serving_fleet(engine, mesh, donate_keys=True)
        single = serving_fleet(engine)
        want = single.route_keys_np(keys_np)
        torch.cuda.synchronize()
        reset_all_launches()
        got = {"host batch": sharded.route_keys_np(keys_np),
               "device batch": sharded.route_keys(keys).full_tensor().cpu().numpy(),
               "donated upload": donating.route_keys_np(keys_np)}
        torch.cuda.synchronize()
        launches[engine] = {"route": kernels.launches["route"]}
        if launches[engine]["route"] != 3 or any(kernels.launches[k] for k in KINDS if k != "route"):
            fail(f"mesh (a)[{engine}]: launches {kernels.launches}, expected route = 3")
        for what, ids in got.items():
            if ids.shape != want.shape or (ids != want).any():
                fail(f"mesh (a)[{engine}]: the sharded route of the {what} differs from the "
                     "unmeshed route_keys")
        if not np.array_equal(keys.cpu().numpy().view(np.uint32), keys_np):
            fail(f"mesh (a)[{engine}]: the caller's device batch was written")
        ms = {"sharded": [], "unmeshed": []}
        for _ in range(3):  # in turns
            ms["sharded"].append(time_ms(lambda: sharded.route_keys(keys)))
            ms["unmeshed"].append(time_ms(lambda: single.route_keys(keys)))
        host = {k: host_ms(lambda r=r: r.route_keys(keys), calls=50)
                for k, r in (("sharded", sharded), ("unmeshed", single))}
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(f"phase 3 mesh (a)[{engine}]: a world of 1 rank over NCCL, make_local_mesh(1); "
              f"{MESH_KEYS} keys on {MESH_FLEET[0]}/{MESH_FLEET[1]} with {MESH_FLEET[2]} failed "
              f"bit-exact with the unmeshed route_keys (host batch, device batch, donated "
              f"upload), one route launch each; in turns x3: sharded {med['sharded']:.4f} ms, "
              f"unmeshed {med['unmeshed']:.4f} ms ({med['sharded'] / med['unmeshed']:.4f}x), "
              f"host per call {host['sharded'] * 1e3:.1f} / {host['unmeshed'] * 1e3:.1f} us on {card}")
    return launches


def mesh_two_ranks_child(rank: int, store: str, out_dir: str) -> None:
    """Part (b), one rank of two sharing ``cuda:0`` over gloo."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()  # a crash in a collective prints where it was
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        result = mesh_two_ranks_body()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))


def mesh_two_ranks_body() -> dict:
    from repro_torch.configs import reduced_config
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import moe
    from repro_torch.sharding import rules

    build.library()
    out: dict = {}
    mesh = make_local_mesh(2, 1, device_type="cuda")  # keys over data
    keys_np = mesh_keys()
    lo, hi, _ = ops.shard_bounds(MESH_KEYS, 2, rules.coordinate(mesh)["data"])
    for engine in ENGINES:
        kernels = BULK_ENGINES[engine].kernels
        sharded, single = serving_fleet(engine, mesh), serving_fleet(engine)
        want = single.route_keys(torch.from_numpy(keys_np.view(np.int32)).cuda())
        torch.cuda.synchronize()
        reset_all_launches()
        got = sharded.route_keys(keys_np)
        row = {"block": hi - lo, "device": str(got.to_local().device),
               "block_ok": bool(torch.equal(got.to_local(), want[lo:hi])),
               # the whole batch: a c10d all-gather of the CUDA blocks
               "whole_ok": bool(np.array_equal(sharded.route_keys_np(keys_np),
                                               want.cpu().numpy()))}
        torch.cuda.synchronize()
        row["route"] = kernels.launches["route"]
        out[engine] = row
    # a float32 EP MoE layer at reduced widths on a (1, 2) mesh: experts
    # over model, the partial outputs summed over the two ranks
    mesh2 = make_local_mesh(1, 2, device_type="cuda")
    cfg = hash_routed(reduced_config(SERVE_ARCH), "binomial")
    m = cfg.moe
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    gen = torch.Generator("cuda").manual_seed(0)
    params = moe.init_moe(gen, cfg)
    B, S = 4, 16
    if B * S * m.top_k <= 4 * m.num_experts:
        raise AssertionError("the EP check's tokens take the dense path")
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        y0, _ = moe.apply_moe(params, x, tok, 3, cfg)
        reset_all_launches()
        with rules.mesh_context(mesh2, expert_layout="ep"):
            local = rules.params_local(params)
            y1, _ = moe.apply_moe(local, x, tok, 3, cfg)  # a c10d all-reduce over model
        torch.cuda.synchronize()
    out["moe"] = {"err": float((y1 - y0).abs().max()), "scale": float(y0.abs().max()),
                  "lookup_router": BULK_ENGINES["binomial"].kernels.launches["lookup_vec"],
                  "experts_wo": list(local["experts_wo"].shape)}
    return out


def mesh_two_ranks(card: str) -> dict:
    """Part (b): two ranks on the one card over gloo (a ``FileStore``,
    joined within ``MESH_JOIN_S``): each routes its block of the 2^24 keys
    in one launch, bit-exact with the unmeshed route's block and, gathered,
    the whole batch; a float32 EP MoE layer on a (1, 2) mesh against the
    same layer unmeshed.  The c10d collectives run on CUDA tensors over
    gloo; DTensor's functional ones crash there, and none is used.  ->
    launches, summed over the ranks."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(mesh_two_ranks_child, args=(str(Path(tmp, "store")), tmp),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_JOIN_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    fail(f"mesh (b): the two ranks did not finish within {MESH_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(2)]
    launches = {e: {"route": 0, "lookup_router": 0} for e in ENGINES}
    for rank, res in enumerate(ranks):
        for engine in ENGINES:
            row = res[engine]
            launches[engine]["route"] += row["route"]
            if row["route"] != 2 or not row["block_ok"] or not row["whole_ok"] \
                    or row["device"] != "cuda:0" or row["block"] != MESH_KEYS // 2:
                fail(f"mesh (b) rank {rank}[{engine}]: {row}")
        mo = res["moe"]
        launches["binomial"]["lookup_router"] += mo["lookup_router"]
        if mo["lookup_router"] != 1 or not mo["err"] <= MESH_EP_TOL * max(1.0, mo["scale"]):
            fail(f"mesh (b) rank {rank}: the EP layer {mo}")
    print(f"phase 3 mesh (b): 2 ranks sharing {card} over gloo (FileStore); per engine each "
          f"rank routed its block of {MESH_KEYS // 2} keys in one launch a batch (route_keys, "
          f"route_keys_np), bit-exact with the unmeshed route's block, and the whole batch "
          f"(a c10d all-gather of the CUDA blocks); the float32 EP MoE layer (reduced "
          f"{SERVE_ARCH}, experts over a (1, 2) mesh, blocks {ranks[0]['moe']['experts_wo']}, "
          f"a c10d all-reduce) within {max(r['moe']['err'] for r in ranks):.3g} of the "
          f"unmeshed layer (tolerance {MESH_EP_TOL})")
    return launches


class StepLog:
    """Wraps ``repro_torch.models.model``'s ``prefill`` and ``decode_step``
    while active, keeping each call's logits (float32, on the host) and
    each decode step's input tokens; given another log as ``forced``, each
    decode step is fed the tokens that log's run was fed (teacher
    forcing), so the two runs' logits compare step by step."""

    def __init__(self, forced=None):
        from repro_torch.models import model as M

        self.M, self.forced, self.logits, self.tokens = M, forced, [], []

    def __enter__(self):
        prefill, decode = self.prefill, self.decode = self.M.prefill, self.M.decode_step

        def logged_prefill(params, batch, cfg, max_len):
            cache, logits = prefill(params, batch, cfg, max_len)
            self.logits.append(logits.float().cpu())
            return cache, logits

        def logged_decode(params, cache, batch, cfg):
            if self.forced is not None:
                batch = {"tokens": self.forced.tokens[len(self.tokens)].to(batch["tokens"].device)}
            self.tokens.append(batch["tokens"].cpu())
            cache, logits = decode(params, cache, batch, cfg)
            self.logits.append(logits.float().cpu())
            return cache, logits

        self.M.prefill, self.M.decode_step = logged_prefill, logged_decode
        return self

    def __exit__(self, *exc):
        self.M.prefill, self.M.decode_step = self.prefill, self.decode


def mesh_serve(card: str, base, params, mesh) -> dict:
    """Part (c): ``ServingTier(mesh=...)`` at full width inside
    ``mesh_context`` of the (1, 1) mesh, expert layout "ep", over phase 3's
    parameters (``params_local`` cuts each leaf to its whole: one rank
    holds every block), per engine: replica ids bit-exact with the
    unmeshed tier, prefill through the EP body and decode through the
    dense GShard path (their calls counted), ``lookup_router`` once per MoE
    layer and model step and route once; every step's logits of a
    teacher-forced meshed run within ``MESH_LOGIT_TOL`` (relative L2) of
    the unmeshed run's; new tokens/s of each.  -> launches."""
    from repro_torch.core.bulk import RouterSpec
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.models.layers import moe
    from repro_torch.serving.engine import ServingTier
    from repro_torch.sharding import rules

    n_moe = sum(k == "attn_moe" for k in base.layer_kinds())
    max_len = MESH_PROMPT + SERVE_NEW + 2
    launches = {}
    for engine in ENGINES:
        cfg = hash_routed(base, engine)
        kernels = BULK_ENGINES[engine].kernels
        reqs = make_requests(cfg.vocab_size, 13, MESH_PROMPT)
        ids = [r.session_id for r in reqs]
        plain = ServingTier(cfg, params, SERVE_REPLICAS, max_len=max_len, engine=engine)
        with rules.mesh_context(mesh, expert_layout="ep"):
            local = rules.params_local(params)
            tier = ServingTier(cfg, local, SERVE_REPLICAS, max_len=max_len, mesh=mesh,
                               router_spec=RouterSpec(engine=engine, capacity=64))
        if tier.router.route_batch(ids).tolist() != plain.router.route_batch(ids).tolist():
            fail(f"mesh (c)[{engine}]: the meshed tier's replica ids differ")
        groups = len(set(plain.router.route_batch(ids).tolist()))
        with StepLog() as ref_log:
            want = plain.serve(reqs)
        with rules.mesh_context(mesh, expert_layout="ep"), StepLog(forced=ref_log) as mesh_log:
            tier.serve(reqs)
        calls = {"_ep_moe": 0, "_dense_moe": 0}
        saved = {name: getattr(moe, name) for name in calls}
        for name, fn in saved.items():
            def counted(*a, _fn=fn, _name=name):
                calls[_name] += 1
                return _fn(*a)
            setattr(moe, name, counted)
        try:
            with rules.mesh_context(mesh, expert_layout="ep"):
                torch.cuda.synchronize()
                reset_all_launches()
                t0 = time.perf_counter()
                got = tier.serve(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches[engine] = {"route": kernels.launches["route"],
                                    "lookup_router": kernels.launches["lookup_vec"]}
        finally:
            for name, fn in saved.items():
                setattr(moe, name, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.serve(reqs)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        check_answers(f"mesh (c)[{engine}]", got, reqs, cfg.padded_vocab)
        want_router = n_moe * (1 + SERVE_NEW) * groups
        if launches[engine] != {"route": 1, "lookup_router": want_router}:
            fail(f"mesh (c)[{engine}]: launches {launches[engine]}, expected route = 1, "
                 f"lookup_router = {n_moe} x (1 + {SERVE_NEW}) x {groups} = {want_router}")
        if calls != {"_ep_moe": n_moe * groups, "_dense_moe": n_moe * SERVE_NEW * groups}:
            fail(f"mesh (c)[{engine}]: mesh branches {calls}, expected the EP body in every "
                 "prefill and the dense path in every decode step")
        if len(mesh_log.logits) != len(ref_log.logits):
            fail(f"mesh (c)[{engine}]: {len(mesh_log.logits)} logged steps against "
                 f"{len(ref_log.logits)}")
        rel = [float((a - b).norm() / b.norm()) for a, b in zip(mesh_log.logits, ref_log.logits)]
        same = sum(np.array_equal(got[i], want[i]) for i in ids)
        print(f"phase 3 mesh (c)[{engine}]: ServingTier(mesh=(1, 1), router_spec) over "
              f"{SERVE_ARCH} at published widths ({base.num_layers} layers, phase 3's weights) "
              f"in mesh_context(expert_layout='ep'): {SERVE_REQUESTS} requests of "
              f"{MESH_PROMPT} tokens x {SERVE_NEW} new on {SERVE_REPLICAS} replicas; replica ids "
              f"bit-exact; EP body x{calls['_ep_moe']} (prefill), dense GShard x"
              f"{calls['_dense_moe']} (decode); launches {json.dumps(launches[engine])}; "
              f"teacher-forced logits of {len(rel)} steps within rel L2 {max(rel):.4g} of the "
              f"unmeshed serve's (gate {MESH_LOGIT_TOL}; median {statistics.median(rel):.4g}); "
              f"free-running tokens identical for {same}/{len(ids)} requests; "
              f"{SERVE_REQUESTS * SERVE_NEW / wall:.1f} new tokens/s meshed against "
              f"{SERVE_REQUESTS * SERVE_NEW / plain_wall:.1f} unmeshed (one serve() each) on {card}")
        if not max(rel) <= MESH_LOGIT_TOL:
            fail(f"mesh (c)[{engine}]: logits {max(rel):.4g} from the unmeshed serve's")
    return launches


def phase_mesh(card: str):
    """Phase "mesh", parts (a) and (b): -> (launches, the (1, 1) mesh that
    part (c) serves under; its process group stays up until then)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_local_mesh(1, 1)
    launches = mesh_one_rank(card, mesh)
    two = mesh_two_ranks(card)
    for engine in ENGINES:
        launches[engine]["route"] += two[engine]["route"]
        launches[engine]["lookup_router"] = two[engine]["lookup_router"]
    return launches, mesh


#: the DeepSeek-V3 serve: its published config (repro_torch.configs), cut
#: from 61 layers to the 3 dense layers and the first 2 MoE layers (two
#: layer salts through lookup_router), the MTP module left out (serving
#: never reads it); the Qwen3 phase's traffic
DSV3_ARCH = "deepseek-v3-671b"
DSV3_LAYERS = 5


def phase_serve_dsv3(card: str) -> dict:
    """ServingTier at full width, DeepSeek-V3 (MLA, a shared expert, 256
    experts) with the hash router, after the Qwen3 phase released its
    weights: -> launches by engine."""
    from repro_torch.configs import get_config

    check_small_model(DSV3_ARCH)
    torch.cuda.synchronize()
    free_before = torch.cuda.memory_allocated()
    published = get_config(DSV3_ARCH)
    base = dataclasses.replace(published, num_layers=DSV3_LAYERS, mtp_depth=0)
    m, a = base.moe, base.mla
    print(f"phase 3 serve {DSV3_ARCH} cuts: layers {published.num_layers} -> {DSV3_LAYERS} (the "
          f"{published.moe_layer_start} dense layers, then {DSV3_LAYERS - published.moe_layer_start}"
          f" MoE layers); MTP depth {published.mtp_depth} -> 0 (serving never reads it); router "
          f"{published.moe.router} -> hash (the published sigmoid router is held on the CPU); "
          f"allocated before init {free_before / 1e9:.3f} GB (the Qwen3 serve's weights released)")
    params, held, step_floor_ms = init_full_width(
        base, card,
        f"serve model: {DSV3_ARCH} at its published widths (d_model {base.d_model}, "
        f"{base.num_heads} heads, MLA ranks {a.q_lora_rank}/{a.kv_lora_rank}, rope "
        f"{a.qk_rope_head_dim}, {m.num_experts} experts top-{m.top_k} of width {m.d_ff_expert}, "
        f"{m.shared_experts} shared expert, dense d_ff {base.d_ff}, vocab {base.vocab_size} "
        f"padded to {base.padded_vocab}), {base.dtype}",
        "5 x 0.374 GB of MLA + 3 x 0.793 GB dense MLPs + 2 x 22.64 GB MoE layers + 3.71 GB "
        "embeddings = 53.2 GB")
    launches, _ = serve_engines(f"serve {DSV3_ARCH}", base, params, held, step_floor_ms, card)
    check_full_width_logits(base, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --- the rest of the LM families ---------------------------------------------

#: the families the serve phases had not run: the token-input ones served
#: through ServingTier (RecurrentGemma-9B first: the slice's headline
#: model), then the embeds-input backbones driven through prefill and
#: decode_step, each at its published widths and depth, bf16, random
#: weights from a seeded generator
FAMILY_SERVED = ("recurrentgemma-9b", "mamba2-1.3b", "starcoder2-7b")
FAMILY_EMBEDS = ("musicgen-medium", "qwen2-vl-7b")
#: parameter bytes reckoned from the JAX package's published configs
#: (``jax.eval_shape`` over its ``init_params``)
FAMILY_RECKONED_GB = {"recurrentgemma-9b": 20.891, "mamba2-1.3b": 2.689,
                      "starcoder2-7b": 14.802, "musicgen-medium": 2.732, "qwen2-vl-7b": 15.232}
#: the long prompt of each family: past RecurrentGemma's window of 2,048 and
#: Starcoder2's of 4,096 (the ring caches), ten SSD chunks of 256 for Mamba2;
#: the embeds backbones (full causal attention) at 512
FAMILY_PROMPT = {"recurrentgemma-9b": 2560, "starcoder2-7b": 4608, "mamba2-1.3b": 2560,
                 "musicgen-medium": 512, "qwen2-vl-7b": 512}
FAMILY_SEQS, FAMILY_DECODE = 2, 8
#: decode against the forward pass, two gates.  In float32 (the weights
#: cast, tensor by tensor, after the bf16 serve) the reference's own: every
#: logit within 2e-3 (``tests/test_models_smoke.py``).  In bf16, as served:
#: the largest relative L2 error of a step's logits, ||decode - forward|| /
#: ||forward||, within 0.1.  The floor of bf16 is what two prefills of the
#: same positions give, one over 8 positions more (and, for the SSD, other
#: chunks): this check's step 0 reads 0.041 (RecurrentGemma) and 0.052
#: (Mamba2) on an H100 at 700 W; 0.1 is twice that, and a wrong cache
#: slot, window edge or carried state moves the logits by O(1)
FAMILY_F32_TOL = 2e-3
FAMILY_BF16_TOL = 0.1
#: the reduced token-input families are served with prompts past the
#: reduced window of 16 (the ring) and three SSD chunks of 8
FAMILY_SMALL_PROMPT = 24


def forward_logits(params, batch, cfg, last: int) -> torch.Tensor:
    """One pass over the whole batch (prefill's layer loop, its caches
    dropped) -> logits (B, last, V) at the last ``last`` positions: the
    reference's decode-matches-forward check reads the forward pass so."""
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.models.layers.common import apply_norm, unembed

    x, positions, token_ids = M._embed_inputs(params, batch, cfg)
    S = x.shape[1]
    for salt, (kind, p) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        x, _, _ = B.block_prefill(p, kind, x, positions, token_ids, salt, cfg, S)
    return unembed(params["embed"], apply_norm(params["final_norm"], x[:, -last:], cfg), cfg)


def family_inputs(cfg, n: int, seed: int) -> dict:
    """Seeded inputs of ``n`` positions on the card: token ids, or
    embeddings of the token embeddings' scale (and, for M-RoPE, a
    vision-like prefix of height/width streams, then text positions)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": torch.randint(0, cfg.vocab_size, (FAMILY_SEQS, n), generator=gen,
                                        device="cuda")}
    batch = {"embeds": (0.02 * torch.randn(FAMILY_SEQS, n, cfg.d_model, generator=gen,
                                           device="cuda")).to(torch.bfloat16)}
    if cfg.input_mode == "embeds_mrope":
        t = torch.arange(n, dtype=torch.int32, device="cuda")
        img = t < n // 2  # a 16-wide patch grid over the first half, then text
        pos = torch.stack([torch.where(img, t // 64, t), torch.where(img, t // 16, t),
                           torch.where(img, t % 16, t)])
        batch["positions"] = pos[:, None].expand(3, FAMILY_SEQS, n).contiguous()
    return batch


def floor_bytes(cfg, params) -> int:
    """The bytes one model step reads: each layer's weights, the final norm
    and the unembedding once (the expert products run over all experts).
    The input table is read a row per token, unless it is tied to the
    unembedding, which reads it whole."""
    table = 0 if cfg.tie_embeddings else tree_bytes(params["embed"]["embedding"])
    return tree_bytes(params) - table


def to_float32(tree):
    """Cast every tensor of ``tree`` to float32 in place, one at a time, so
    that each one's bf16 copy is released as its float32 copy is made."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            to_float32(v)
        else:
            tree[k] = v.float()


def decode_against_forward(arch: str, cfg, params, card: str) -> dict:
    """``FAMILY_SEQS`` sequences of ``FAMILY_PROMPT[arch]`` positions
    prefilled, then ``FAMILY_DECODE`` decode steps fed the next positions'
    inputs; prefill's and each step's logits against a forward pass over
    all the positions; the decode steps timed beside the floor of the
    bytes each reads (the weights and the caches). -> the relative L2 error
    per step and the largest absolute one."""
    from repro_torch.models import model as M

    L, n = FAMILY_PROMPT[arch], FAMILY_DECODE
    data = family_inputs(cfg, L + n, seed=31)
    pre = {k: (v[:, :, :L] if k == "positions" else v[:, :L]) for k, v in data.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = M.prefill(params, pre, cfg, L + n + 1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache_bytes = tree_bytes(cache["layers"])
    steps = [logits]
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    t0 = time.perf_counter()
    for t in range(L, L + n):
        cache, logits = M.decode_step(params, cache, {key: data[key][:, t:t + 1]}, cfg)
        steps.append(logits)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n
    fwd_cfg = cfg
    if cfg.ssm is not None and (L + n) % min(cfg.ssm.chunk, L + n):
        # the SSD pass needs whole chunks: the forward pass takes the largest
        # chunk that divides its length (the SSD's result does not depend on
        # the chunk; its rounding does)
        chunk = max(d for d in range(1, cfg.ssm.chunk + 1) if (L + n) % d == 0)
        fwd_cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    want = forward_logits(params, data, fwd_cfg, n + 1).float()
    got = torch.stack(steps, dim=1).float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{arch} long prompt: logits {tuple(got.shape)} against {tuple(want.shape)}, finite "
             f"{bool(torch.isfinite(got).all())}")
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).amax(0).tolist()  # per step
    max_abs = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    windowed = [c for c in cache["layers"] if "pos" in c and c["pos"].shape[1] < L]
    ring = (f"ring caches of {windowed[0]['pos'].shape[1]} slots in {len(windowed)} layers"
            if windowed else "no ring cache")
    floor_ms = (floor_bytes(cfg, params) + cache_bytes) / hw.HBM_BW * 1e3
    print(f"phase 3 {arch} long prompt, {cfg.dtype}: {FAMILY_SEQS} x {L} positions"
          + (f" (forward pass SSD chunk {fwd_cfg.ssm.chunk})" if fwd_cfg is not cfg else "")
          + f", {ring}; prefill {prefill_ms:.1f} ms; {n} decode steps {decode_ms:.2f} ms each "
          f"({FAMILY_SEQS / decode_ms * 1e3:.1f} new tokens/s; floor {floor_ms:.2f} ms: the "
          f"weights and {cache_bytes / 1e6:.1f} MB of caches at {hw.HBM_BW / 1e12} TB/s); "
          f"against the forward pass, prefill then each step, relative L2 "
          + ", ".join(f"{r:.3g}" for r in rel)
          + f"; max |diff| {max_abs:.3g} of max |logit| {float(want.abs().max()):.3f}; greedy "
          f"agreement {agree:.3f} on {card}")
    return {"rel": rel, "max_abs": max_abs}


def check_small_embeds(arch: str) -> None:
    """The reduced embeds-input model of ``arch`` on the card (float32)
    against the CPU: prefill of 24 positions and three decode steps,
    logits within ``SMALL_LOGIT_TOL``."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(8)
    embeds = torch.from_numpy(rng.standard_normal((3, 27, cfg.d_model)).astype(np.float32))
    batch = {"embeds": embeds[:, :24]}
    if cfg.input_mode == "embeds_mrope":
        t = torch.arange(24, dtype=torch.int32)
        batch["positions"] = torch.stack([t, t // 2, t % 3])[:, None].expand(3, 3, 24).contiguous()
    runs = []
    for p, dev in ((M.params_to(params, "cuda"), "cuda"), (params, "cpu")):
        cache, logits = M.prefill(p, {k: v.to(dev) for k, v in batch.items()}, cfg, 28)
        steps = [logits.cpu()]
        for t in range(24, 27):
            cache, logits = M.decode_step(p, cache, {"embeds": embeds[:, t:t + 1].to(dev)}, cfg)
            steps.append(logits.cpu())
        runs.append(torch.stack(steps))
    err = float((runs[0] - runs[1]).abs().max())
    print(f"phase 3 reduced {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.input_mode}, {cfg.pos_emb}, float32): prefill and 3 decode steps, card vs CPU "
          f"max |logit diff| {err:.3g} (tolerance {SMALL_LOGIT_TOL})")
    if not err <= SMALL_LOGIT_TOL:
        fail(f"the reduced {arch} on the card disagrees with the CPU")


def phase_serve_families(card: str) -> dict:
    """The families the earlier serve phases left out, one model at a
    time, each one's weights released before the next: the reduced model
    on the card against the CPU; then at full width and depth ServingTier
    with the serve traffic
    per engine (token-input families; RecurrentGemma profiled once), and
    the long-prompt decode against the forward pass in bf16 and, the
    weights cast, in float32.  -> launches by family and engine."""
    from repro_torch.configs import get_config

    launches = {}
    for arch in FAMILY_SERVED + FAMILY_EMBEDS:
        clock = [time.perf_counter()]

        def lap():
            clock.append(time.perf_counter())
            return f"{clock[-1] - clock[-2]:.1f}"

        if arch in FAMILY_SERVED:
            check_small_model(arch, FAMILY_SMALL_PROMPT)
        else:
            check_small_embeds(arch)
        laps = {"reduced": lap()}
        base = get_config(arch)
        kinds = {k: base.layer_kinds().count(k) for k in sorted(set(base.layer_kinds()))}
        params, held, step_floor_ms = init_full_width(
            base, card,
            f"{arch} at its published widths (d_model {base.d_model}, layers {json.dumps(kinds)}, "
            f"window {base.window}, {base.input_mode} inputs, {base.pos_emb} positions, vocab "
            f"{base.vocab_size} padded to {base.padded_vocab}), {base.dtype}, all "
            f"{base.num_layers} layers",
            f"{FAMILY_RECKONED_GB[arch]} GB")
        laps["init"] = lap()
        if arch in FAMILY_SERVED:
            launches[arch], _ = serve_engines(
                f"serve {arch}", base, params, held, step_floor_ms, card,
                profiled=ENGINES[:1] if arch == FAMILY_SERVED[0] else ())
            check_full_width_logits(base, params)
            laps["serve"] = lap()
        bf16 = decode_against_forward(arch, base, params, card)
        laps["long bf16"] = lap()
        to_float32(params)
        f32 = decode_against_forward(
            arch, dataclasses.replace(base, dtype="float32", param_dtype="float32"), params, card)
        laps["long float32"] = lap()
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 3 {arch}: decode against the forward pass, bf16 largest relative L2 "
              f"{max(bf16['rel']):.4f} (tolerance {FAMILY_BF16_TOL}), float32 largest |diff| "
              f"{f32['max_abs']:.3g} (tolerance {FAMILY_F32_TOL}); seconds "
              + json.dumps(laps) + f", {clock[-1] - clock[0]:.1f} in all")
        if not max(bf16["rel"]) <= FAMILY_BF16_TOL or not f32["max_abs"] <= FAMILY_F32_TOL:
            fail(f"{arch}: decode departs from the forward pass (bf16 relative L2 "
                 f"{max(bf16['rel']):.4f}, float32 |diff| {f32['max_abs']:.3g})")
    return launches


# --- training ----------------------------------------------------------------

#: the reduced models trained on the card against the CPU (float32, TF32
#: off): Qwen3 on the hash router of each engine, DeepSeek-V3 as published
#: (MLA, the sigmoid router, a shared expert, the MTP loss), RecurrentGemma
#: (RG-LRU, a sliding window) and Mamba2 (SSD); prompts past the reduced
#: window of 16, three SSD chunks of 8
TRAIN_SMALL = (("qwen3-moe-235b-a22b", "binomial"), ("qwen3-moe-235b-a22b", "jump"),
               ("deepseek-v3-671b", None), ("recurrentgemma-9b", None), ("mamba2-1.3b", None))
TRAIN_SMALL_SEQ = 24
#: the card and the CPU sum in other orders: every loss, metric, gradient
#: and updated leaf within 1e-4 of max(1, max |CPU|), the CPU tests'
#: tolerance against the JAX package; expert ids identical
TRAIN_TOL = 1e-4
#: the full-width run: Qwen3-235B-A22B at its published widths, its 94
#: layers cut to 1 (one MoE layer), bf16, AdamW with master weights, remat
#: "full"; 2 sequences of 2,048 tokens from ShardedDataPipeline, the same
#: batch at each of 6 steps, from the same seed on each engine
TRAIN_ARCH, TRAIN_LAYERS = SERVE_ARCH, 1
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6
TRAIN_LR = 1e-3
#: router calls a step per MoE layer: the forward and remat's recomputation
TRAIN_ROUTES_PER_LAYER = 2
#: bytes a parameter the AdamW step must move: bf16 parameters read and
#: written (4), the bf16 gradient read (2), the float32 master, m and v
#: read and written (24)
OPT_BYTES = 30


def to_device(tree, device):
    """A copy of ``tree`` on ``device`` (a train step updates its state in
    place)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device, copy=True), tree)


def train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """A seeded CPU batch: tokens and targets (the last 3 of the first row
    -1), or embeddings and targets."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)))
    out = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
    out["targets"][0, -3:] = -1
    return out


def close_by(got, want, what: str) -> float:
    """max |got - want| against ``TRAIN_TOL`` of max(1, max |want|)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        fail(f"{what}: shapes {tuple(got.shape)} and {tuple(want.shape)}")
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not err <= TRAIN_TOL * max(1.0, float(want.abs().max()) if want.numel() else 0.0):
        fail(f"{what}: the card departs from the CPU by {err:.3g}")
    return err


def check_small_training() -> None:
    """Each ``TRAIN_SMALL`` model's loss, metrics and every gradient on the
    card against the CPU, expert ids identical; then one AdamW step with
    ``grad_accum=2`` and an active clip on both, every state leaf."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import (
        TrainHparams, loss_and_grads, make_train_state, make_train_step)
    from repro_torch.tree import flatten_with_path, leaves

    torch.backends.cuda.matmul.allow_tf32 = False  # the defaults, stated
    torch.backends.cudnn.allow_tf32 = False
    for arch, engine in TRAIN_SMALL:
        cfg = reduced_config(arch)
        if engine is not None:
            cfg = hash_routed(cfg, engine)
        params = M.init_train_params(torch.Generator().manual_seed(0), cfg)
        batch = train_batch(cfg, 2, TRAIN_SMALL_SEQ, 5)
        runs = {}
        for device in ("cuda", "cpu"):
            with RouteLog() as log:
                out = loss_and_grads(to_device(params, device), to_device(batch, device), cfg)
            runs[device] = out, [(salt, ids.cpu()) for salt, _, ids in log.calls]
        (loss, metrics, grads), calls = runs["cuda"]
        (want_loss, want_metrics, want_grads), want_calls = runs["cpu"]
        if [s for s, _ in calls] != [s for s, _ in want_calls] or not all(
                torch.equal(a, b) for (_, a), (_, b) in zip(calls, want_calls)):
            fail(f"train {arch}: the card's expert ids differ from the CPU's")
        worst = max(close_by(metrics[k], want_metrics[k], f"train {arch} {k}") for k in want_metrics)
        paths = [k for k, _ in flatten_with_path(params)]
        worst_grad = max(close_by(g, w, f"train {arch} grad {k}")
                         for k, g, w in zip(paths, grads, want_grads))
        hp = TrainHparams(grad_accum=2, clip_norm=0.05)
        batch4 = train_batch(cfg, 4, TRAIN_SMALL_SEQ, 6)
        states = {}
        for device in ("cuda", "cpu"):
            opt = make_optimizer("adamw", lr=TRAIN_LR, warmup=0, total=10)
            state = make_train_state(to_device(params, device), opt, hp)
            states[device] = make_train_step(cfg, opt, hp)(state, to_device(batch4, device))
        (state, m), (want_state, want_m) = states["cuda"], states["cpu"]
        if not float(want_m["grad_norm"]) > hp.clip_norm:
            fail(f"train {arch}: the clip was not active")
        worst_step = max([close_by(m[k], want_m[k], f"train {arch} step {k}") for k in want_m] + [
            close_by(a.float(), b.float(), f"train {arch} step {k}") for (k, a), b in
            zip(flatten_with_path(state), leaves(want_state))])
        print(f"phase 3 train reduced {arch}{f'[{engine}]' if engine else ''} "
              f"({cfg.num_layers} layers {'/'.join(sorted(set(cfg.layer_kinds())))}, "
              f"{cfg.moe.router if cfg.moe else 'no'} router, 2 x {TRAIN_SMALL_SEQ} tokens, float32, "
              f"TF32 off: matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, cudnn."
              f"allow_tf32 {torch.backends.cudnn.allow_tf32}): "
              f"card vs CPU loss {float(loss):.6f} / {float(want_loss):.6f}, metrics within "
              f"{worst:.3g}, {len(grads)} gradients within {worst_grad:.3g}, {len(calls)} router "
              f"calls with identical expert ids; one AdamW step (grad_accum 2, clip 0.05 of "
              f"{float(want_m['grad_norm']):.4f}) within {worst_step:.3g} over "
              f"{len(leaves(state))} state leaves (tolerance {TRAIN_TOL} of max(1, |CPU|))")


def train_floor(cfg, n_params: int, expert_ids: torch.Tensor) -> dict:
    """The least time one training step at full width could take: the
    larger of its products' FLOPs at the bf16 peak and the bytes it must
    move at ``hw.HBM_BW``.  FLOPs: three times the forward's products
    (the forward, then the gradients of inputs and weights; remat's
    recomputation not counted): attention's projections, its scores and
    values over the causal pairs only, the experts' three products over
    the assignments kept under the capacity (counted from this run's expert
    ids) and the unembedding.  Bytes: every bf16 weight read by the forward
    and by the backward, every gradient written, then ``OPT_BYTES`` a
    parameter for the AdamW step (activations not counted)."""
    from repro_torch.models.layers.moe import _capacity

    B, S = TRAIN_BATCH, TRAIN_SEQ
    T, D = B * S, cfg.d_model
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m = cfg.moe
    counts = torch.bincount(expert_ids.reshape(-1).long().cpu(), minlength=m.num_experts)
    kept = int(counts.clamp(max=_capacity(cfg, T)).sum())
    forward = cfg.num_layers * (2 * T * D * (H + 2 * G) * hd + 2 * T * H * hd * D
                                + 4 * hd * H * B * S * (S + 1) // 2
                                + kept * 2 * 3 * D * m.d_ff_expert) + 2 * T * D * cfg.padded_vocab
    flops = 3 * forward
    nbytes = n_params * (2 + 2 + 2 + OPT_BYTES)
    flop_ms, byte_ms = flops / hw.PEAK_FLOPS_BF16 * 1e3, nbytes / hw.HBM_BW * 1e3
    return dict(flops=flops, bytes=nbytes, kept=kept, flop_ms=flop_ms, byte_ms=byte_ms,
                floor_ms=max(flop_ms, byte_ms), bound_by="bytes" if byte_ms >= flop_ms else "operations")


def roofline_train_step(tag: str, step, state, batch, floor: dict, card: str):
    """One more step under ``repro_torch.roofline.analyze``: the FLOPs its
    aten products count (this run's shapes) beside the ones ``train_floor``
    reckons.  Remat "full" recomputes the whole forward in the backward
    (each layer and each cross-entropy chunk, the unembedding included), so
    the counted products come to 4/3 of the reckoned three forwards, plus
    what the port computes and the reckoning leaves out: the scores of
    every query-key pair (not only the causal half), once more for the
    attention's per-query-chunk checkpoint, and the experts' padded
    capacity buffers (not only the kept assignments).  -> the state after
    the step."""
    from repro_torch.roofline.analysis import analyze
    from repro_torch.tree import leaves

    out = {}
    opt_gb = adamw_bytes(leaves(state["params"])) / 1e9
    roof = analyze(lambda: out.update(step=step(state, batch)), model_flops_total=floor["flops"])
    torch.cuda.synchronize()
    print(f"phase 3 {tag} roofline (repro_torch.roofline.analyze of one step): "
          f"{roof.flops / 1e12:.3f} TFLOP counted over the step's matrix products (torch's flop "
          f"counter: {roof.raw_flops / 1e12:.3f}) against {floor['flops'] / 1e12:.3f} reckoned, "
          f"{roof.flops / floor['flops']:.4f} of it (remat full recomputes the forward: 4/3 of "
          f"the reckoned three forwards, plus the full score squares, once more for the "
          f"attention chunks' checkpoint, and the capacity buffers); "
          f"{roof.hbm_bytes / 1e9:.1f} GB at tensor granularity (aten operators only: the "
          f"adamw_update launches' {opt_gb:.1f} GB are not among them); compute term "
          f"{roof.compute_s * 1e3:.2f} ms at {hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s, memory term "
          f"{roof.memory_s * 1e3:.2f} ms at {hw.HBM_BW / 1e12} TB/s ({roof.dominant}) on {card}")
    return out["step"][0]


def check_train_forward(cfg, params, batch) -> float:
    """The training forward's last-token logits against ``prefill``'s over
    the same tokens, both bf16: the largest relative L2 of a sequence,
    within the families' bf16 gate ``FAMILY_BF16_TOL``."""
    from repro_torch.models import model as M
    from repro_torch.models.layers.common import unembed

    with torch.no_grad():
        hidden, *_ = M.trunk_train(params, batch, cfg)
        train = unembed(params["embed"], hidden[:, -1:], cfg)[:, 0].float()
        del hidden
        _, served = M.prefill(M.per_layer(params, cfg), {"tokens": batch["tokens"]}, cfg, TRAIN_SEQ)
    rel = float(((train - served.float()).norm(dim=-1) / served.float().norm(dim=-1)).max())
    if not rel <= FAMILY_BF16_TOL:
        fail(f"train {cfg.name}: the training forward's logits depart from prefill's by {rel:.4f}")
    return rel


def profile_train_step(tag: str, step, state, batch, floor_ms: float, card: str,
                       found: dict | None = None):
    """One more step under ``torch.profiler``: the device's busy share of
    the wall and the kernels that take it; ``found`` (when given) gets the
    device ms by part and of the ``adamw_kernel`` launches.  -> the
    state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ops = [e for e in events if e.key.startswith("aten::")]
    # the step's record_function ranges also appear on the device's timeline
    # as annotations spanning their kernels: not kernels themselves
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("train_step/")]
    if not kernels:
        print(f"phase 3 {tag} profiled step: the profiler recorded no device time "
              f"(wall {wall_ms:.1f} ms)")
        return state
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the clip and the optimizer launch every kernel from this thread, inside
    # their ranges (the host-side events sum those kernels' device time); the
    # backward launches from autograd's device thread, outside any range, so
    # the forward and backward are the rest of the device time
    parts = {e.key.split("/")[1]: e.device_time_total / 1e3 for e in events
             if e.device_type == DeviceType.CPU
             and e.key in ("train_step/clip", "train_step/optimizer")}
    # the AdamW kernel is launched through ctypes, not by an aten op, so the
    # profiler leaves its device time out of the range's: it runs inside
    # the optimizer's range alone
    adamw = [e for e in kernels if "adamw_kernel" in e.key]
    if "optimizer" in parts:
        parts["optimizer"] += sum(e.self_device_time_total for e in adamw) / 1e3
    parts["forward and backward (the rest)"] = busy_ms - sum(parts.values())
    if found is not None:
        found.update(parts=parts, adamw_ms=sum(e.self_device_time_total for e in adamw) / 1e3,
                     adamw_launches=sum(e.count for e in adamw))
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    print(f"phase 3 {tag} profiled step: wall {wall_ms:.1f} ms, {sum(e.count for e in ops)} "
          f"torch operators, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}; floor "
          f"{floor_ms:.1f} ms) on {card}; device ms by part: " + json.dumps(
              {k: round(v, 2) for k, v in parts.items()}) + "; top operators by device time: "
          + "; ".join(f"{e.key} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top)
          + "; adamw_kernel " + ", ".join(
              f"{e.key.split('(')[0]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
              for e in adamw))
    return state


def adamw_bytes(leaves_) -> int:
    """The bytes one AdamW step over these parameter leaves must move with
    master weights: each gradient read (its dtype), m, v and the master
    read and written (24 B), each parameter written (its dtype)."""
    return sum(p.numel() * (2 * p.element_size() + 24) for p in leaves_)


def train_full_width(card: str) -> dict:
    """Qwen3-235B-A22B at its published widths, one MoE layer, trained
    ``TRAIN_STEPS`` steps per engine from the same seed, the launch counts
    set to 0 just before the steps and read just after; AdamW one
    ``adamw_update`` launch a leaf a step, its device ms a step from the
    profiled step beside its bound.  -> launches by engine and the AdamW
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.data.pipeline import DataConfig, ShardedDataPipeline
    from repro_torch.kernels import train as T
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import make_train_state, make_train_step
    from repro_torch.tree import leaves

    published = get_config(TRAIN_ARCH)
    base = dataclasses.replace(published, num_layers=TRAIN_LAYERS)
    m = base.moe
    pipe = ShardedDataPipeline(DataConfig(base.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 1, 0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in pipe.batch(0).items()}
    n_moe = sum(k == "attn_moe" for k in base.layer_kinds())
    print(f"phase 3 train {TRAIN_ARCH} cuts: layers {published.num_layers} -> {TRAIN_LAYERS} (one "
          f"MoE layer); router {m.router} -> hash (softmax top-k is held on the CPU and in the "
          f"reduced check); widths as published (d_model {base.d_model}, {base.num_heads}/"
          f"{base.num_kv_heads} heads of {base.resolved_head_dim}, {m.num_experts} experts top-"
          f"{m.top_k} of {m.d_ff_expert}, vocab {base.vocab_size} padded to {base.padded_vocab}), "
          f"{base.param_dtype}, remat {base.remat}, AdamW (lr {TRAIN_LR}, master weights); "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens of ShardedDataPipeline's step 0, every step")
    launches, numbers = {}, {}
    for engine in ENGINES:
        cfg = hash_routed(base, engine)
        kernels = BULK_ENGINES[engine].kernels
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_train_params(torch.Generator("cuda").manual_seed(0), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params, held = M.count_params(params), tree_bytes(params)
        rel = check_train_forward(cfg, params, batch)
        opt = make_optimizer("adamw", lr=TRAIN_LR, warmup=0, total=TRAIN_STEPS)
        state = make_train_state(params, opt)
        del params
        step = make_train_step(cfg, opt)
        state_bytes = tree_bytes(state)
        n_leaves = len(leaves(state["params"]))
        opt_bytes = adamw_bytes(leaves(state["params"]))
        reset_all_launches()
        losses, walls = [], []
        with RouteLog() as log:
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches[engine] = {"lookup_router": kernels.launches["lookup_vec"],
                            "adamw_update": T.launches["adamw_update"]}
        if launches[engine]["adamw_update"] != n_leaves * TRAIN_STEPS:
            fail(f"train[{engine}]: {launches[engine]['adamw_update']} adamw_update launches, "
                 f"expected one a leaf a step, {n_leaves} x {TRAIN_STEPS}")
        want = TRAIN_ROUTES_PER_LAYER * n_moe * TRAIN_STEPS
        if launches[engine]["lookup_router"] != want or len(log.calls) != want:
            fail(f"train[{engine}]: {launches[engine]['lookup_router']} lookup_router launches "
                 f"and {len(log.calls)} router calls, expected {TRAIN_ROUTES_PER_LAYER} x {n_moe} "
                 f"MoE layers x {TRAIN_STEPS} steps = {want}")
        for salt, tokens, expert_ids in log.calls:
            plain = kernels.lookup_router_plain(tokens, salt, m.top_k, m.num_experts,
                                                cfg.moe.router_hash_omega)
            if expert_ids.shape != (TRAIN_BATCH, TRAIN_SEQ, m.top_k) or not torch.equal(expert_ids, plain):
                fail(f"train[{engine}]: the expert ids of layer {salt} differ from the plain lookup's")
        ln_v = float(np.log(base.vocab_size))
        if not np.isfinite(losses).all() or not abs(losses[0] - ln_v) < 2.0 \
                or not losses[-1] < losses[0]:
            fail(f"train[{engine}]: losses {losses} (step 0 should be near ln V = {ln_v:.3f} and "
                 "the loss should fall)")
        floor = train_floor(cfg, n_params, log.calls[0][2])
        ms = statistics.median(walls[1:]) * 1e3
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"phase 3 train {TRAIN_ARCH}[{engine}]: {n_params / 1e9:.3f} G parameters "
              f"({held / 1e9:.3f} GB, init {init_s:.2f} s), train state {state_bytes / 1e9:.3f} GB; "
              f"{TRAIN_STEPS} steps of {tokens} tokens: losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f" (ln V = {ln_v:.4f}); {statistics.median(walls[1:]) * 1e3:.1f} ms a step (median "
              f"of steps 2-{TRAIN_STEPS}; all: " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
              + f"), {tokens / ms * 1e3:,.0f} tokens/s; peak memory {peak / 1e9:.3f} GB; floor "
              f"{floor['floor_ms']:.2f} ms ({floor['bound_by']}: {floor['flops'] / 1e12:.2f} TFLOP "
              f"at {hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s = {floor['flop_ms']:.2f} ms, "
              f"{floor['bytes'] / 1e9:.1f} GB at {hw.HBM_BW / 1e12} TB/s = "
              f"{floor['byte_ms']:.2f} ms; {floor['kept']} expert assignments kept of "
              f"{tokens * m.top_k}), {floor['floor_ms'] / ms:.3f} of it; lookup_router "
              f"{launches[engine]['lookup_router'] / TRAIN_STEPS:g} launches a step "
              f"({TRAIN_ROUTES_PER_LAYER} x {n_moe} MoE layer: the forward and remat's "
              f"recomputation), every expert id (2, {TRAIN_SEQ}, {m.top_k}) equal to the plain "
              f"lookup's; adamw_update {launches[engine]['adamw_update'] / TRAIN_STEPS:g} "
              f"launches a step (one a leaf); step-0 training forward vs prefill, last-token "
              f"logits, bf16 relative L2 {rel:.4f} (gate {FAMILY_BF16_TOL}) on {card}")
        state = roofline_train_step(f"train {TRAIN_ARCH}[{engine}]", step, state, batch, floor,
                                    card)
        found: dict = {}
        state = profile_train_step(f"train {TRAIN_ARCH}[{engine}]", step, state, batch,
                                   floor["floor_ms"], card, found)
        opt_bound = opt_bytes / hw.HBM_BW * 1e3
        numbers[engine] = dict(ms=ms, losses=losses, opt_bound_ms=opt_bound, **found)
        if found:
            parts = found["parts"]
            print(f"phase 3 train {TRAIN_ARCH}[{engine}] AdamW: {ms:.1f} ms a step; the profiled "
                  f"step's train_step/optimizer range {parts['optimizer']:.2f} ms, "
                  f"train_step/clip {parts['clip']:.2f} ms (the norm; the scale folded into the "
                  f"update); adamw_kernel {found['adamw_ms']:.3f} ms over "
                  f"{found['adamw_launches']} launches (one a leaf) against a bound of "
                  f"{opt_bound:.3f} ms ({opt_bytes / 1e9:.2f} GB at {hw.HBM_BW / 1e12} TB/s: "
                  f"bf16 gradient read, float32 m, v and master read and written, bf16 parameter "
                  f"written), share {share(opt_bound, found['adamw_ms'])} on {card}")
        del state, step, opt
        gc.collect()
        torch.cuda.empty_cache()
    return launches, numbers


def adamw_times(card: str) -> dict:
    """``adamw_update`` on the full-width cell's largest leaf (experts_wi,
    bf16 gradient and parameter, master weights), timed with the train
    state freed: the kernel beside its bound, its plain version, and
    ``torch._fused_adamw_`` (what ``torch.optim.AdamW(fused=True)`` calls;
    the port never calls it) on the same leaf with the gradient cast to
    float32 and the bf16 copy of the master weight included, as the port's
    update must do them.  -> the kernel line's row."""
    from repro_torch.kernels import train as T

    ops_ = adamw_operands(EXPERTS_WI, torch.bfloat16, torch.bfloat16, True, (0, 0), 60)
    g, m, v, master, p = (ops_[k] for k in ("g", "m", "v", "ref", "p"))
    args = (ops_["lr"], ops_["c1"], ops_["c2"], ops_["lr_wd"], torch.tensor(0.5, device="cuda"))

    def kernel():
        T.adamw_update(g, m, v, master, p, *args, b1=0.9, b2=0.95, eps=1e-8)

    def plain():
        T.adamw_update_plain(g, m, v, master, p, *args, b1=0.9, b2=0.95, eps=1e-8)

    steps = [torch.tensor(1.0, device="cuda")]

    def library():
        torch._fused_adamw_([master], [g.float()], [m], [v], [], steps, lr=1e-3, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False,
                            maximize=False)
        p.copy_(master)

    times = {name: [] for name in ("kernel", "plain", "library")}
    cases = {"kernel": kernel, "plain": plain, "library": library}
    for which in ("kernel", "library", "plain", "plain", "library", "kernel"):
        times[which].append(time_ms(cases[which], launches=3 if which == "plain" else 10,
                                    repeats=3))
    med = {k: statistics.median(v) for k, v in times.items()}
    nbytes = adamw_bytes([p])
    bound_ms = nbytes / hw.HBM_BW * 1e3
    print(f"phase 3 train adamw_update on experts_wi ({EXPERTS_WI:,} elements, bf16 gradient and "
          f"parameter, master weights, clip scale 0.5), the train state freed, in turns: kernel "
          f"{med['kernel']:.3f} ms ({', '.join(f'{t:.3f}' for t in times['kernel'])}) against a "
          f"bound of {bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB at {hw.HBM_BW / 1e12} TB/s), share "
          f"{share(bound_ms, med['kernel'])}; torch._fused_adamw_ with the float32 cast of the "
          f"gradient and the bf16 copy {med['library']:.3f} ms ("
          f"{', '.join(f'{t:.3f}' for t in times['library'])}); the plain version "
          f"{med['plain']:.3f} ms ({', '.join(f'{t:.3f}' for t in times['plain'])}) on {card}")
    del ops_, g, m, v, master, p
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=med["kernel"], plain_ms=med["plain"], library_ms=med["library"],
                bound_ms=bound_ms, bound_by="bytes", elements=EXPERTS_WI)


def check_launcher() -> None:
    """``python -m repro_torch.launch.train`` on the card: the 100m preset
    for 20 steps, then on to 30, resuming from its own checkpoint, in a
    temporary directory removed afterwards."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        outs = []
        for steps in (20, 30):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-3b",
                 "--preset", "100m", "--steps", str(steps), "--ckpt-dir", tmp],
                capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
            if run.returncode != 0:
                fail(f"launch.train --steps {steps} exited {run.returncode}: {run.stderr[-2000:]}")
            outs.append((run.stdout, time.perf_counter() - t0))
        (first, first_s), (second, second_s) = outs
        resumed = re.findall(r"resuming from checkpoint step (\d+)", second)
        losses = [float(x) for x in re.findall(r"loss=(\S+)", second)]
        from repro_torch.training.checkpoint import CheckpointManager

        latest = CheckpointManager(tmp).latest_step()
        if "resuming" in first or resumed != ["20"] or not losses or \
                not np.isfinite(losses).all() or latest != 30:
            fail(f"launch.train did not resume: {second[-2000:]}")
        head = first.splitlines()[0]
        print(f"phase 3 train launcher: `python -m repro_torch.launch.train --arch stablelm-3b "
              f"--preset 100m --steps 20` ({head}) in {first_s:.1f} s, last line "
              f"{first.strip().splitlines()[-2].strip()!r}; then --steps 30 resumed from step "
              f"{resumed[0]} in {second_s:.1f} s, losses {losses}, latest checkpoint {latest}; "
              "the directory removed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_bf16_checkpoint() -> None:
    """A bf16 train state of the reduced Qwen3 (hash router) on the card,
    after one step: saved, restored onto the card, every leaf bit for bit,
    the bf16 leaves written under descr '<V2' as the reference writes them."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import make_train_state, make_train_step
    from repro_torch.tree import flatten_with_path

    cfg = hash_routed(dataclasses.replace(reduced_config(TRAIN_ARCH), dtype="bfloat16",
                                          param_dtype="bfloat16"), "binomial")
    opt = make_optimizer("adamw", lr=TRAIN_LR, warmup=0, total=10)
    state = make_train_state(M.init_train_params(torch.Generator("cuda").manual_seed(0), cfg), opt)
    state, _ = make_train_step(cfg, opt)(state, to_device(train_batch(cfg, 2, 16, 7), "cuda"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(tmp, n_nodes=3)
        path = mgr.save(1, state)
        back = mgr.restore(mgr.latest_step(), state)
        n_bf16 = 0
        for (key, a), (_, b) in zip(flatten_with_path(back), flatten_with_path(state)):
            if a.dtype != b.dtype or a.device != b.device:
                fail(f"bf16 checkpoint: {key} came back as {a.dtype} on {a.device}")
            if a.dtype == torch.bfloat16:
                n_bf16 += 1
                a, b = a.view(torch.int16), b.view(torch.int16)
            if not torch.equal(a, b):
                fail(f"bf16 checkpoint: {key} differs after the round trip")
        v2 = 0
        for name in os.listdir(path):
            if name.endswith(".npz"):
                with zipfile.ZipFile(os.path.join(path, name)) as z:
                    v2 += sum(b"'descr': '<V2'" in z.read(n)[:128] for n in z.namelist())
        if n_bf16 == 0 or v2 != n_bf16:
            fail(f"bf16 checkpoint: {n_bf16} bf16 leaves, {v2} members under '<V2'")
        print(f"phase 3 train bf16 checkpoint: reduced {TRAIN_ARCH} state after one step on the "
              f"card, {len(flatten_with_path(state))} leaves ({n_bf16} bf16, written under descr "
              f"'<V2') over 3 storage nodes, restored onto the card bit for bit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_train(card: str) -> tuple[dict, dict]:
    """The training slice: the reduced models on the card against the CPU,
    Qwen3-235B-A22B at full width per engine, ``adamw_update`` timed on its
    largest leaf, the launcher with a resume, a bf16 checkpoint round trip.
    -> (launches by engine (the full-width steps), the AdamW row's
    numbers)."""
    t0 = time.perf_counter()
    check_small_training()
    launches, numbers = train_full_width(card)
    row = adamw_times(card)
    row["in_step"] = numbers
    check_launcher()
    check_bf16_checkpoint()
    print(f"phase 3 train: {time.perf_counter() - t0:.1f} s")
    return launches, row


# --- the meshed training path -----------------------------------------------

#: part (a): the full-width run of phase "train" under a one-rank NCCL
#: (1, 1) mesh with fsdp and ZeRO-1, 3 steps per engine, against the same
#: steps unmeshed (the losses within MESH_TRAIN_LOSS_TOL, the grad norms
#: within MESH_TRAIN_NORM_TOL, relative; the peak within MESH_TRAIN_PEAK
#: of the unmeshed run's).  A step moves the loss by about 1.6e-3 and the
#: grad norm by about 0.9 % relative, so a meshed step that updated
#: nothing fails both; the unmeshed steps run twice, and the spread of the
#: two runs is printed beside the meshed departure.
MESH_TRAIN_STEPS = 3
MESH_TRAIN_LOSS_TOL = 2e-4
MESH_TRAIN_NORM_TOL = 1e-3
MESH_TRAIN_PEAK = 1.05
#: part (b): 4 gloo ranks sharing the card on a (2, 2) mesh, fsdp on,
#: float32 (TF32 off), reduced configs: the five cases of
#: tests/test_mesh_numerics.py and the attention modes (name, arch, expert
#: layout, config overrides), 2 AdamW steps with master weights at
#: TRAIN_LR; every rank's blocks within MESH_TRAIN_TOL of the unmeshed port
#: on the card (of max(1, max |leaf|) for weights, of max |leaf| for
#: moments).  Adam's first steps move an element by about lr * sign(g),
#: so an element whose gradient is float noise away from zero departs at
#: the scale of lr: the tolerance holds at lr 1e-3, not at 1e-2.
MESH_TRAIN_CASES = (
    ("qwen3/ep", "qwen3-moe-235b-a22b", "ep", {}),
    ("qwen3/tp", "qwen3-moe-235b-a22b", "tp", {"router": "hash", "remat": "full"}),
    ("deepseek-v3/ep", "deepseek-v3-671b", "ep", {}),
    ("stablelm-3b", "stablelm-3b", "ep", {}),
    ("mamba2-1.3b", "mamba2-1.3b", "ep", {}),
    ("rhead", "stablelm-3b", "ep", {"num_heads": 4, "num_kv_heads": 1}),
    ("seq", "stablelm-3b", "ep", {"num_heads": 3, "num_kv_heads": 3, "head_dim": 16}),
    ("local", "stablelm-3b", "ep", {"num_heads": 3, "num_kv_heads": 3, "head_dim": 16,
                                    "window": 8}),
)
MESH_TRAIN_TOL = 1e-4
MESH_TRAIN_RANKS = 4


@contextlib.contextmanager
def plain_adamw():
    """AdamW's update through its plain version while active (the kernel's
    wrapper swapped for it), for a run to hold the kernel's against."""
    from repro_torch.kernels import train as T

    kernel = T.adamw_update
    T.adamw_update = T.adamw_update_plain
    try:
        yield
    finally:
        T.adamw_update = kernel


def mesh_train_full_width(card: str, engine: str) -> dict:
    """Part (a) for one engine: the full-width state from one seed, 3
    steps unmeshed (twice, and once more with AdamW's plain version in
    place of its kernel), then the same from the same seed under the (1, 1)
    mesh; the launch counts set to 0 just before the meshed steps and read
    just after.  -> numbers and launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.data.pipeline import DataConfig, ShardedDataPipeline
    from repro_torch.kernels import train as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import make_train_state, make_train_step
    from repro_torch.tree import leaves

    cfg = hash_routed(dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS), engine)
    pipe = ShardedDataPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 1, 0)
    # the pipeline's steps 0, 1, 2: one batch repeated is learnt within a
    # step or two (the loss falls from 12.75 to 3e-5), where a relative
    # comparison of the losses measures nothing
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in pipe.batch(i).items()}
               for i in range(MESH_TRAIN_STEPS)]
    kernels = BULK_ENGINES[engine].kernels
    mesh = make_local_mesh(1, 1, device_type="cuda")
    runs = {}
    for run in ("unmeshed", "repeat", "plain", "meshed"):
        meshed = run == "meshed"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctx = rules.mesh_context(mesh, fsdp=True, expert_layout="ep") if meshed else contextlib.nullcontext()
        with ctx, plain_adamw() if run == "plain" else contextlib.nullcontext():
            params = M.init_train_params(torch.Generator("cuda").manual_seed(0), cfg)
            opt = make_optimizer("adamw", lr=TRAIN_LR, warmup=0, total=MESH_TRAIN_STEPS)
            state = make_train_state(params, opt)
            del params
            step = make_train_step(cfg, opt)
            torch.cuda.synchronize()
            reset_all_launches()
            losses, norms, walls = [], [], []
            for batch in batches:
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
                walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        runs[run] = {"losses": losses, "norms": norms, "ms": statistics.median(walls[1:]) * 1e3,
                        "peak": torch.cuda.max_memory_allocated(),
                        "lookup_router": kernels.launches["lookup_vec"],
                        "adamw_update": T.launches["adamw_update"],
                        "leaves": len(leaves(state["params"]))}
        del state, step, opt
    a, b = runs["unmeshed"], runs["meshed"]
    spread = {k: max(abs(p - q) / abs(p) for p, q in zip(a[k], runs["repeat"][k]))
              for k in ("losses", "norms")}
    depart = {k: max(abs(p - q) / abs(p) for p, q in zip(a[k], b[k])) for k in ("losses", "norms")}
    plain = {k: max(abs(p - q) / abs(p) for p, q in zip(a[k], runs["plain"][k]))
             for k in ("losses", "norms")}
    want = TRAIN_ROUTES_PER_LAYER * MESH_TRAIN_STEPS
    if b["lookup_router"] != want:
        fail(f"mesh train (a)[{engine}]: {b['lookup_router']} lookup_router launches, expected {want}")
    if b["adamw_update"] != b["leaves"] * MESH_TRAIN_STEPS or runs["plain"]["adamw_update"]:
        fail(f"mesh train (a)[{engine}]: {b['adamw_update']} adamw_update launches meshed (one a "
             f"leaf a step expected: {b['leaves']} x {MESH_TRAIN_STEPS}), "
             f"{runs['plain']['adamw_update']} with the plain update")
    for x, y, tol, what in ((a["losses"], b["losses"], MESH_TRAIN_LOSS_TOL, "losses"),
                            (a["norms"], b["norms"], MESH_TRAIN_NORM_TOL, "grad norms"),
                            (runs["plain"]["losses"], a["losses"], MESH_TRAIN_LOSS_TOL,
                             "losses (the kernel's update against the plain one)"),
                            (runs["plain"]["norms"], a["norms"], MESH_TRAIN_NORM_TOL,
                             "grad norms (the kernel's update against the plain one)")):
        if not all(np.isfinite(y)) or any(abs(p - q) > tol * abs(p) for p, q in zip(x, y)):
            fail(f"mesh train (a)[{engine}]: {what} meshed {y} vs unmeshed {x} (tolerance {tol})")
    if not b["peak"] <= MESH_TRAIN_PEAK * a["peak"]:
        fail(f"mesh train (a)[{engine}]: peak {b['peak'] / 1e9:.3f} GB meshed vs "
             f"{a['peak'] / 1e9:.3f} GB unmeshed")
    print(f"phase 3 mesh train (a)[{engine}]: {TRAIN_ARCH} at published widths, "
          f"{TRAIN_LAYERS} layer, bf16, AdamW + master, remat {cfg.remat}, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens of ShardedDataPipeline's steps 0-{MESH_TRAIN_STEPS - 1}; one NCCL rank, (1, 1) mesh, fsdp, ZeRO-1 applied, "
          f"{MESH_TRAIN_STEPS} steps: losses " + ", ".join(f"{x:.5f}" for x in b["losses"])
          + " (unmeshed " + ", ".join(f"{x:.5f}" for x in a["losses"]) + "), grad norms "
          + ", ".join(f"{x:.4f}" for x in b["norms"]) + " (unmeshed "
          + ", ".join(f"{x:.4f}" for x in a["norms"]) + f"); {b['ms']:.1f} ms a step vs "
          f"{a['ms']:.1f} ms unmeshed (median of steps 2-{MESH_TRAIN_STEPS}); peak "
          f"{b['peak'] / 1e9:.3f} GB vs {a['peak'] / 1e9:.3f} GB unmeshed; lookup_router "
          f"{b['lookup_router'] / MESH_TRAIN_STEPS:g} launches a step on {card}; largest relative "
          f"departure meshed vs unmeshed: losses {depart['losses']!r}, grad norms "
          f"{depart['norms']!r}; unmeshed run twice: losses {spread['losses']!r}, grad norms "
          f"{spread['norms']!r}; AdamW's kernel against its plain version (unmeshed, "
          f"{a['ms']:.1f} vs {runs['plain']['ms']:.1f} ms a step): losses {plain['losses']!r}, "
          f"grad norms {plain['norms']!r}; adamw_update {b['adamw_update'] / MESH_TRAIN_STEPS:g} "
          f"launches a meshed step (one a leaf)")
    return {"launches": b["lookup_router"], "adamw_update": b["adamw_update"], "ms": b["ms"],
            "unmeshed_ms": a["ms"], "plain_ms": runs["plain"]["ms"], "plain_depart": plain,
            "peak": b["peak"], "unmeshed_peak": a["peak"], "depart": depart, "spread": spread}


def mesh_train_case_config(arch: str, over: dict):
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    over = dict(over)
    router = over.pop("router", None)
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(moe, router=router) if router else moe)
    return dataclasses.replace(cfg, **over)


def mesh_train_rank_body(device: str) -> dict:
    """One rank of part (b): per case, 2 AdamW steps of the unmeshed port
    on the card from the seed, then 2 meshed ZeRO-1 steps from the same
    state cut to this rank's blocks; the largest departure of its blocks
    (parameters and optimizer state) from the unmeshed ones cut the same
    way, and the lookup_router launches of the meshed steps."""
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import attention
    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import _spec_leaves, make_optimizer, zero1_pspecs
    from repro_torch.training.train_step import make_train_state, make_train_step, shard_batch
    from repro_torch.tree import flatten_with_path, leaves, unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_local_mesh(2, 2, device_type="cuda" if device == "cuda" else "cpu")
    out = {}
    for name, arch, lay, over in MESH_TRAIN_CASES:
        cfg = mesh_train_case_config(arch, over)
        gen = torch.Generator(device).manual_seed(0)
        params = M.init_train_params(gen, cfg)
        opt = make_optimizer("adamw", lr=TRAIN_LR, warmup=0, total=10)
        full = make_train_state(to_device(params, device), opt)
        start = to_device(full, "cpu")
        batches = [{k: v.to(device) for k, v in train_batch(cfg, 4, 16, 10 + i).items()}
                   for i in range(2)]
        step = make_train_step(cfg, opt)
        for b in batches:
            full, _ = step(full, b)
        with rules.mesh_context(mesh, fsdp=True, expert_layout=lay):
            pspecs = rules.params_pspecs(start["params"])
            zspecs = zero1_pspecs(start["params"], pspecs, start["opt"])
            cut = lambda tree, specs: unflatten(tree, [  # noqa: E731
                rules.local_slice(t, sp, mesh).contiguous().to(device)
                for t, sp in zip(leaves(tree), _spec_leaves(specs))])
            state = {"params": cut(start["params"], pspecs), "opt": cut(start["opt"], zspecs),
                     "step": start["step"].to(device)}
            mstep = make_train_step(cfg, opt)
            reset_all_launches()
            for b in batches:
                state, _ = mstep(state, shard_batch(b))
            if device == "cuda":
                torch.cuda.synchronize()
            launches = BULK_ENGINES["binomial"].kernels.launches["lookup_vec"]
            errs = []
            for kind, specs in (("params", pspecs), ("opt", zspecs)):
                for (path, got), want, sp in zip(flatten_with_path(state[kind]), leaves(full[kind]),
                                                 _spec_leaves(specs)):
                    want = rules.local_slice(want, sp, mesh).detach().double().cpu()
                    got = got.detach().double().cpu()
                    moment = kind == "opt" and "['master']" not in path
                    scale = float(want.abs().max()) if moment else max(1.0, float(want.abs().max()))
                    errs.append(float((got - want).abs().max()) / max(scale, 1e-30))
            out[name] = {"rel_err": max(errs), "lookup_router": launches,
                         "mode": None if cfg.attention == "mla" or cfg.num_heads == 0
                         else attention._mode(cfg, 16)}
    return out


def mesh_train_rank(rank: int, store: str, out_dir: str, device: str, body: str) -> None:
    """One of ``MESH_TRAIN_RANKS`` gloo ranks running the rank function
    named ``body`` on ``device``; its result as JSON under ``out_dir``."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, MESH_TRAIN_RANKS), rank=rank,
                            world_size=MESH_TRAIN_RANKS)
    try:
        if device == "cuda":
            from repro_torch.kernels import build

            build.library()
        result = globals()[body](device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))


def run_ranks(body: str, device: str, what: str) -> list:
    """``MESH_TRAIN_RANKS`` gloo ranks sharing the card (spawned, a
    ``FileStore``, joined within ``MESH_JOIN_S``), each running the rank
    function named ``body``.  -> their results, in rank order."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(mesh_train_rank,
                                 args=(str(Path(tmp, "store")), tmp, device, body),
                                 nprocs=MESH_TRAIN_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_JOIN_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    fail(f"{what}: the ranks did not finish within {MESH_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(MESH_TRAIN_RANKS)]


def mesh_train_ranks(card: str, device: str = "cuda") -> int:
    """Part (b): ``MESH_TRAIN_RANKS`` gloo ranks sharing the card.  -> the
    lookup_router launches of the meshed steps, summed over the ranks."""
    t0 = time.perf_counter()
    ranks = run_ranks("mesh_train_rank_body", device, "mesh train (b)")
    modes = {ranks[0][name]["mode"] for name, *_ in MESH_TRAIN_CASES}
    if not {"head", "rhead", "seq", "local"} <= modes:
        fail(f"mesh train (b): attention modes {modes}")
    worst = {}
    launches = 0
    for rank, res in enumerate(ranks):
        for name, arch, lay, over in MESH_TRAIN_CASES:
            row = res[name]
            worst[name] = max(worst.get(name, 0.0), row["rel_err"])
            want = 2 * 2 * 3 if over.get("router") == "hash" else 0  # forward + remat, 3 layers
            if row["lookup_router"] != want or not row["rel_err"] <= MESH_TRAIN_TOL:
                fail(f"mesh train (b) rank {rank} {name}: {row} (lookup_router expected {want})")
            launches += row["lookup_router"]
    print(f"phase 3 mesh train (b): {MESH_TRAIN_RANKS} gloo ranks sharing {card}, (2, 2) mesh, "
          f"fsdp, float32 (TF32 off), 2 AdamW + master ZeRO-1 steps; every rank's parameter and "
          f"optimizer blocks against the unmeshed port on the card, largest departure "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tolerance {MESH_TRAIN_TOL}); attention modes {sorted(m for m in modes if m)}; "
          f"lookup_router {launches // MESH_TRAIN_RANKS} launches a rank "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches


def phase_mesh_train(card: str) -> dict:
    """The meshed training path: (a) the full width under a one-rank mesh
    per engine, (b) four ranks on the reduced configs.  -> launches by
    engine."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    launches = {}
    for engine in ENGINES:
        got = mesh_train_full_width(card, engine)
        launches[engine] = {"lookup_router": got["launches"], "adamw_update": got["adamw_update"]}
    dist.destroy_process_group()
    launches["binomial"]["lookup_router"] += mesh_train_ranks(card)
    print(f"phase 3 mesh train: {time.perf_counter() - t0:.1f} s")
    return launches


# --- gradient compression under a mesh -----------------------------------------

COMPRESS_KINDS = ("int8", "topk")
COMPRESS_STEPS = 3
#: part (b)'s reduced cases: name, arch, expert layout, config overrides
COMPRESS_CASES = (("qwen3/tp", "qwen3-moe-235b-a22b", "tp", {"router": "hash", "remat": "full"}),
                  ("stablelm-3b", "stablelm-3b", "ep", {}))
COMPRESS_LR = 1e-3
#: the CPU tests' tolerance (``tests/test_torch_compression_mesh.py``): a
#: block within 1e-4 of its scale, but for the elements whose compression
#: flips between two runs whose sums differ in order (at most this share
#: of a leaf), which may move apart by the steps' updates
COMPRESS_TOL = 1e-4
COMPRESS_FLIP_SHARE = 1e-3
#: a topk flip's |gf| lies this close to the threshold, relatively
COMPRESS_NEAR = 1e-5


class SelectCheck:
    """While active, and while ``armed``, holds each threshold the train
    step's ``compression.kth_magnitude`` returns against ``torch.topk``'s
    k-th value of the same leaf on the card, bit for bit, and the kept
    count (elements at or above it) against k plus the ties; keeps the
    largest leaf's block and k for timing."""

    def __init__(self):
        from repro_torch.training import compression as C

        self.C, self.select = C, C.kth_magnitude
        self.armed, self.checked, self.bad, self.largest = False, 0, [], None

    def __enter__(self):
        def checked(gf, k, axes=()):
            t = self.select(gf, k, axes)
            if self.armed:
                mags = gf.abs().reshape(-1)
                want = torch.topk(mags, k).values[-1]
                above, kept = int((mags > t).sum()), int((mags >= t).sum())
                if int(t.view(torch.int32)) != int(want.view(torch.int32)) or not above < k <= kept:
                    self.bad.append((tuple(gf.shape), k, float(t), float(want), above, kept))
                self.checked += 1
                if self.largest is None or gf.numel() > self.largest[0].numel():
                    self.largest = (gf.detach().clone(), k)
                del mags
            return t

        self.C.kth_magnitude = checked
        return self

    def __exit__(self, *exc):
        self.C.kth_magnitude = self.select


def compress_step_parts(step, state, batch):
    """One more step under ``torch.profiler``, with the peak memory of each
    part (the counts reset as each part begins: the forward and backward,
    the compression and the clip, the optimizer).  -> (the state, the
    device ms of the kernels launched inside ``train_step/compress``, or
    None when the profiler recorded no device time, peak bytes by part,
    the device ms of the select's kernels in the step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training import compression as C
    from repro_torch.training.optimizer import Adafactor

    peaks = {}
    compress, update = C.compress, Adafactor.update

    def note(part):
        if part not in peaks:
            peaks[part] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def compress_noted(*args, **kw):
        note("forward and backward")
        return compress(*args, **kw)

    def update_noted(self, *args, **kw):
        note("compress and clip")
        return update(self, *args, **kw)

    C.compress, Adafactor.update = compress_noted, update_noted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        note("optimizer")
    finally:
        C.compress, Adafactor.update = compress, update
    events = prof.key_averages()
    ms = [e.device_time_total / 1e3 for e in events
          if e.device_type == DeviceType.CPU and e.key == "train_step/compress"]
    select = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
                 and ("radix_hist_kernel" in e.key or "radix_pick_kernel" in e.key)) / 1e3
    # the select's kernels are launched through ctypes, not by aten ops, so
    # the profiler leaves their device time out of the range's
    compress = ms[0] + select if ms and ms[0] > 0 else None
    return state, compress, peaks, select


def select_times(gf: torch.Tensor, k: int) -> dict:
    """The select on one leaf ``gf`` at ``k``, in turns: the kernels
    (``radix_kth_magnitude``: three ``radix_hist`` + ``radix_pick``
    rounds), ``torch.topk`` of the magnitudes (the port's select before
    this on the unmeshed path; never called by the meshed one), and the
    plain rounds; each round's ``radix_hist`` launch alone (with the
    prefix its round reads) and ``radix_pick``'s launch (behind a sleeping
    kernel).  The bound: the leaf read once at ``hw.HBM_BW``."""
    from repro_torch.kernels import train as T
    from repro_torch.training import compression as C

    mags = gf.abs().reshape(-1)
    flat = gf.reshape(-1)
    cases = {"kernel": lambda: C.radix_kth_magnitude(gf, k),
             "topk": lambda: torch.topk(mags, k),
             "plain": lambda: T.radix_select_plain(gf, k)}
    times = {w: [] for w in cases}
    for which in ("kernel", "topk", "plain", "plain", "topk", "kernel"):
        times[which].append(time_ms(cases[which], launches=1, repeats=3))
    med = {w: statistics.median(v) for w, v in times.items()}
    final = int(C.radix_kth_magnitude(gf, k).view(torch.int32))
    hist_ms, hist_plain_ms, hist = [], [], None
    for shift, width in T.RADIX_ROUNDS:
        top = shift + width
        prefix = torch.tensor([final & ~((1 << top) - 1) if top < 32 else 0], dtype=torch.int32,
                              device=gf.device)
        hist_ms.append(time_ms(lambda p=prefix, s=shift, w=width: T.radix_hist(flat, p, s, w),
                               launches=3, repeats=3))
        hist_plain_ms.append(time_ms(
            lambda p=prefix, s=shift, w=width: T.radix_hist_plain(flat, p, s, w),
            launches=1, repeats=3))
        if hist is None:  # the first round's: every element counted, 2^11 bins
            hist = T.radix_hist(flat, prefix, shift, width)
    # each pick leaves a rank within the digit it keeps, so repeated picks
    # over the first round's histogram always find one
    sought = torch.full((1,), k, dtype=torch.int64, device=gf.device)
    prefix = torch.zeros(1, dtype=torch.int32, device=gf.device)
    pick_ms, _ = small_call_ms(lambda: T.radix_pick(hist, sought, prefix, 0))
    pick_plain_ms, _ = small_call_ms(lambda: T.radix_pick_plain(hist, sought, prefix, 0), 50)
    bound_ms = 4 * gf.numel() / hw.HBM_BW * 1e3
    del mags
    return {"elements": gf.numel(), "k": k, "ms": med["kernel"], "topk_ms": med["topk"],
            "plain_ms": med["plain"], "turns": times, "hist_ms": hist_ms,
            "hist_plain_ms": hist_plain_ms, "pick_ms": pick_ms, "pick_plain_ms": pick_plain_ms,
            "bound_ms": bound_ms}


def compress_full_width(card: str, engine: str) -> dict:
    """Part (a) for one engine: the full-width train cell (``TRAIN_ARCH`` at
    its published widths, one layer, bf16, the hash router) with Adafactor,
    per compression ``COMPRESS_STEPS`` steps unmeshed, then the same from
    the same seed under a one-rank NCCL (1, 1) mesh with fsdp and ZeRO-1;
    the launch counts set to 0 just before the meshed steps and read just
    after; with ``topk`` every leaf's threshold of the first meshed step
    held against ``torch.topk``.  -> lookup_router launches and numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.data.pipeline import DataConfig, ShardedDataPipeline
    from repro_torch.kernels import train as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import rules
    from repro_torch.training import compression as C
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import TrainHparams, make_train_state, make_train_step
    from repro_torch.tree import leaves

    cfg = hash_routed(dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS), engine)
    pipe = ShardedDataPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 1, 0)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in pipe.batch(i).items()}
               for i in range(COMPRESS_STEPS)]
    kernels = BULK_ENGINES[engine].kernels
    mesh = make_local_mesh(1, 1, device_type="cuda")
    out = {"lookup_router": 0, "radix_hist": 0, "radix_pick": 0}
    for kind in COMPRESS_KINDS:
        hp = TrainHparams(compression=kind)
        runs, checks = {}, []
        for meshed in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ctx = (rules.mesh_context(mesh, fsdp=True, expert_layout="ep") if meshed
                   else contextlib.nullcontext())
            with ctx, SelectCheck() as check:
                params = M.init_train_params(torch.Generator("cuda").manual_seed(0), cfg)
                opt = make_optimizer("adafactor", lr=TRAIN_LR, warmup=0, total=COMPRESS_STEPS)
                state = make_train_state(params, opt, hp)
                del params
                step = make_train_step(cfg, opt, hp)
                n_params = sum(p.numel() for p in leaves(state["params"]))
                n_leaves = len(leaves(state["params"]))
                sizes = {k: tree_bytes(state[k]) for k in ("params", "opt", "comp_err")}
                torch.cuda.synchronize()
                reset_all_launches()
                losses, norms, walls = [], [], []
                for i, batch in enumerate(batches):
                    check.armed = kind == "topk" and i == 0
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch)
                    losses.append(float(metrics["loss"]))
                    norms.append(float(metrics["grad_norm"]))
                    walls.append(time.perf_counter() - t0)
                    if i == 0:  # the peak of the steps after the first (and its check)
                        if check.largest is not None:  # kept off the card meanwhile
                            check.largest = (check.largest[0].cpu(), check.largest[1])
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                check.armed = False
                run = {"losses": losses, "norms": norms, "peak": torch.cuda.max_memory_allocated(),
                       "ms": statistics.median(walls[1:]) * 1e3, "walls": walls,
                       "lookup_router": kernels.launches["lookup_vec"], "sizes": sizes,
                       **{k: T.launches[k] for k in ("radix_hist", "radix_pick")}}
                want = 3 * n_leaves * COMPRESS_STEPS if kind == "topk" else 0
                if (run["radix_hist"], run["radix_pick"]) != (want, want):
                    fail(f"compress (a)[{engine}] {kind}: radix_hist {run['radix_hist']} and "
                         f"radix_pick {run['radix_pick']} launches, expected three a leaf a "
                         f"step, {want}")
                checks.append(check)
                if meshed:
                    state, run["compress_ms"], run["parts"], run["select_ms"] = \
                        compress_step_parts(step, state, batches[0])
                runs["meshed" if meshed else "unmeshed"] = run
                del state, step, opt
        a, b = runs["unmeshed"], runs["meshed"]
        want = TRAIN_ROUTES_PER_LAYER * COMPRESS_STEPS
        if b["lookup_router"] != want:
            fail(f"compress (a)[{engine}] {kind}: {b['lookup_router']} lookup_router launches, "
                 f"expected {want}")
        for x, y, tol, what in ((a["losses"], b["losses"], MESH_TRAIN_LOSS_TOL, "losses"),
                                (a["norms"], b["norms"], MESH_TRAIN_NORM_TOL, "grad norms")):
            if not all(np.isfinite(y)) or any(abs(p - q) > tol * abs(p) for p, q in zip(x, y)):
                fail(f"compress (a)[{engine}] {kind}: {what} meshed {y} vs unmeshed {x} "
                     f"(tolerance {tol})")
        select = ""
        if kind == "topk":
            for c, what in zip(checks, ("unmeshed", "meshed")):
                if c.bad or c.checked != n_leaves:
                    fail(f"compress (a)[{engine}] {what}: the select checked {c.checked} of "
                         f"{n_leaves} leaves; against torch.topk: {c.bad[:4]}")
            gf, k = check.largest
            gf = gf.cuda()
            checks[0].largest = check.largest = None
            numbers = select_times(gf, k)
            torch.cuda.synchronize()
            previous = torch.cuda.get_sync_debug_mode()  # a synchronising call raises
            torch.cuda.set_sync_debug_mode("error")
            try:
                C.radix_kth_magnitude(gf, k)
                C.kth_magnitude(gf, k)
            except RuntimeError as e:
                import traceback

                traceback.print_exc()
                fail(f"compress (a)[{engine}]: the select waits for the device: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(previous)
            gap = b["ms"] - a["ms"]
            select = (f"; every leaf's threshold ({checks[0].checked} unmeshed, "
                      f"{checks[1].checked} meshed) equal to torch.topk's k-th value bit for bit, "
                      f"kept = k + ties; radix_hist and radix_pick 3 launches each a leaf a step; "
                      f"the select's kernels {b['select_ms']:.3f} ms over the profiled meshed "
                      f"step's {n_leaves} leaves, beside the meshed step's {gap:.1f} ms over the "
                      f"unmeshed; on the largest leaf ({gf.numel():,} elements, k = {k:,}) the "
                      f"select {numbers['ms']:.3f} ms (rounds' radix_hist "
                      + ", ".join(f"{t:.3f}" for t in numbers["hist_ms"])
                      + " ms, plain " + ", ".join(f"{t:.3f}" for t in numbers["hist_plain_ms"])
                      + f" ms; radix_pick {numbers['pick_ms'] * 1e3:.2f} us, plain "
                      f"{numbers['pick_plain_ms'] * 1e3:.2f} us) against a bound of "
                      f"{numbers['bound_ms']:.3f} ms (the leaf read once at {hw.HBM_BW / 1e12} "
                      f"TB/s; the design's three reads {3 * numbers['bound_ms']:.3f} ms), share "
                      f"{share(numbers['bound_ms'], numbers['ms'])}; torch.topk "
                      f"{numbers['topk_ms']:.3f} ms; the plain rounds {numbers['plain_ms']:.3f} "
                      f"ms; no host synchronisation")
            out[engine, "select"] = {**numbers, "step_select_ms": b["select_ms"], "gap_ms": gap}
            del gf
        comp = b.get("compress_ms")
        print(f"phase 3 compress (a)[{engine}] {kind}: {TRAIN_ARCH} at published widths, "
              f"{TRAIN_LAYERS} layer, bf16, hash router, Adafactor (lr {TRAIN_LR}), "
              f"{n_params / 1e9:.3f} G parameters ({b['sizes']['params'] / 1e9:.3f} GB), optimizer "
              f"state {b['sizes']['opt'] / 1e9:.3f} GB, residual {b['sizes']['comp_err'] / 1e9:.3f} "
              f"GB (ZeRO-1 blocks, float32); {COMPRESS_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens, one NCCL rank, (1, 1) mesh, fsdp: losses "
              + ", ".join(f"{x:.5f}" for x in b["losses"]) + " (unmeshed "
              + ", ".join(f"{x:.5f}" for x in a["losses"]) + "), grad norms "
              + ", ".join(f"{x:.4f}" for x in b["norms"]) + " (unmeshed "
              + ", ".join(f"{x:.4f}" for x in a["norms"]) + f"); {b['ms']:.1f} ms a step vs "
              f"{a['ms']:.1f} ms unmeshed (median of steps 2-{COMPRESS_STEPS}; all "
              + ", ".join(f"{w * 1e3:.1f}" for w in b["walls"]) + "), train_step/compress "
              + ("not measured (no device time recorded)" if comp is None else f"{comp:.2f} ms")
              + f" of a profiled step; peak of steps 2-{COMPRESS_STEPS} {b['peak'] / 1e9:.3f} GB (unmeshed "
              f"{a['peak'] / 1e9:.3f} GB; by part of the profiled step "
              + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in b["parts"].items())
              + f"); lookup_router {b['lookup_router'] / COMPRESS_STEPS:g} "
              f"launches a step{select} on {card}")
        out[engine, kind] = {"ms": b["ms"], "unmeshed_ms": a["ms"], "compress_ms": comp,
                             "peak": b["peak"], "unmeshed_peak": a["peak"], "parts": b["parts"]}
        out["lookup_router"] += b["lookup_router"]
        out["radix_hist"] += b["radix_hist"]
        out["radix_pick"] += b["radix_pick"]
    gc.collect()
    torch.cuda.empty_cache()  # the ranks of part (b) share the card
    return out


def compress_blocks(state, full, specs, kind, mesh, threshes) -> dict:
    """A rank's blocks of ``state`` after one meshed step against ``full``
    (the unmeshed port's state after the same step from the same state)
    cut the same way, held as ``tests/test_torch_compression_mesh.py::
    _note_flips`` holds a rank to the reference.  A residual element whose
    compression flipped between the two runs (their sums differ in order)
    departs by more than half a quantum (int8) or beyond ``COMPRESS_TOL``
    of its leaf's scale (topk: kept on one side only, its ``|gf|`` within
    ``COMPRESS_NEAR`` of the meshed threshold ``threshes[i]``); the
    parameter and optimizer state of a flipped element (from every rank's
    blocks) may move apart by one step's update.  -> the largest departure
    of the other elements as a share of their leaf's scale (a residual's
    is its gradient's: 254 times its largest element with int8, its largest
    with topk; a moment's its largest; a weight's at least 1), the flipped
    elements over the whole leaves, whether every leaf flipped at most
    ``COMPRESS_FLIP_SHARE`` of its elements and every flip is one of those,
    and the largest departure of a flipped element's parameter or optimizer
    state."""
    import torch.distributed as dist

    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import _spec_leaves
    from repro_torch.tree import flatten_with_path, leaves

    row = {"rel_err": 0.0, "flips": 0, "flips_ok": True, "flip_err": 0.0}
    flipped = {}

    def blocks(part):
        return zip(flatten_with_path(state[part]), leaves(full[part]), _spec_leaves(specs[part]))

    for i, ((path, got), whole, sp) in enumerate(blocks("comp_err")):
        want = rules.local_slice(whole, sp, mesh).detach().double().cpu()
        got = got.detach().double().cpu()
        top = float(whole.detach().abs().max())
        scale = max(top, 1e-30) * (254 if kind == "int8" else 1)
        d = (got - want).abs()
        if kind == "int8":
            off = d > top / 2
            ok = float(d.max()) <= 2 * top * (1 + 1e-3) + COMPRESS_TOL * scale
        else:
            off = d > COMPRESS_TOL * scale
            one_side = (got == 0) != (want == 0)
            mag = torch.where(got == 0, want.abs(), got.abs())
            near = (mag - threshes[i]).abs() <= COMPRESS_NEAR * threshes[i]
            ok = bool(one_side[off].all()) and bool(near[off].all())
        row["flips_ok"] &= ok and int(off.sum()) <= max(1, int(d.numel() * COMPRESS_FLIP_SHARE))
        row["rel_err"] = max(row["rel_err"], float(torch.where(off, 0.0, d).max()) / scale)
        mine = torch.zeros(tuple(whole.shape))  # this rank's flips, placed in the whole leaf
        rules.local_slice(mine, sp, mesh).copy_(off.float())
        dist.all_reduce(mine)
        flipped[path] = mine > 0
        row["flips"] += int(flipped[path].sum())
    for part in ("params", "opt"):
        for (path, got), whole, sp in blocks(part):
            key = path
            for prefix in ("['m']", "['v']", "['master']"):
                key = key.removeprefix(prefix)
            mask = rules.local_slice(flipped[key], sp, mesh)
            want = rules.local_slice(whole, sp, mesh).detach().double().cpu()
            d = (got.detach().double().cpu() - want).abs()
            floor = 0.0 if path.startswith(("['m']", "['v']")) else 1.0
            scale = max(float(whole.detach().abs().max()), 1e-30, floor)
            row["rel_err"] = max(row["rel_err"], float(torch.where(mask, 0.0, d).max()) / scale)
            row["flip_err"] = max(row["flip_err"], float(torch.where(mask, d, 0.0).max()))
    return row


def gather_state(state, like, specs, mesh, device):
    """Every rank's blocks of ``state`` put together into the whole state
    (shaped and typed like ``like``) on ``device``: each leaf summed over
    the ranks in float64 and divided by its copies, which is exact."""
    import torch.distributed as dist

    from repro_torch.sharding import rules
    from repro_torch.training.optimizer import _spec_leaves
    from repro_torch.tree import leaves, unflatten

    out = {"step": state["step"].detach().cpu().to(device, copy=True)}
    for part, spec in specs.items():
        whole = []
        for b, w, sp in zip(leaves(state[part]), leaves(like[part]), _spec_leaves(spec)):
            acc = torch.zeros(tuple(w.shape), dtype=torch.float64)
            copies = torch.zeros(tuple(w.shape), dtype=torch.float64)
            rules.local_slice(acc, sp, mesh).copy_(b.detach().double().cpu())
            rules.local_slice(copies, sp, mesh).fill_(1.0)
            dist.all_reduce(acc)
            dist.all_reduce(copies)
            whole.append((acc / copies).to(w.dtype).to(device))
        out[part] = unflatten(like[part], whole)
    return out


def compress_rank_body(device: str) -> dict:
    """One rank of part (b): per case and compression, 2 meshed ZeRO-1
    AdamW (master weights) steps on the card from the seed, each held
    against the unmeshed port's step from the same state (the first from
    the seed, the second from every rank's blocks after the first put
    together, so that a residual read back at the second step is held to
    the same tolerance as the first step's): this rank's parameter,
    optimizer and residual blocks (``compress_blocks``), the losses and
    grad norms of both, and the lookup_router launches of the meshed
    steps."""
    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import rules
    from repro_torch.training import compression as C
    from repro_torch.training.optimizer import _spec_leaves, make_optimizer, zero1_pspecs
    from repro_torch.training.train_step import (TrainHparams, make_train_state, make_train_step,
                                                 shard_batch)
    from repro_torch.tree import leaves, unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_local_mesh(2, 2, device_type="cuda" if device == "cuda" else "cpu")
    select, threshes = C.kth_magnitude, []

    def recorded(gf, k, axes=()):  # the meshed step's thresholds, in leaf order
        t = select(gf, k, axes)
        threshes.append(float(t))
        return t

    out = {}
    C.kth_magnitude = recorded
    try:
        for name, arch, lay, over in COMPRESS_CASES:
            cfg = mesh_train_case_config(arch, over)
            ctx = lambda: rules.mesh_context(mesh, fsdp=True, expert_layout=lay)  # noqa: E731
            for kind in COMPRESS_KINDS:
                hp = TrainHparams(compression=kind)
                params = M.init_train_params(torch.Generator(device).manual_seed(0), cfg)
                opt = make_optimizer("adamw", lr=COMPRESS_LR, warmup=0, total=10)
                start = to_device(make_train_state(to_device(params, device), opt, hp), "cpu")
                batches = [{k: v.to(device) for k, v in train_batch(cfg, 4, 16, 20 + i).items()}
                           for i in range(2)]
                step = make_train_step(cfg, opt, hp)
                with ctx():
                    pspecs = rules.params_pspecs(start["params"])
                    specs = {"params": pspecs,
                             "opt": zero1_pspecs(start["params"], pspecs, start["opt"]),
                             "comp_err": zero1_pspecs(start["params"], pspecs,
                                                      {"m": start["comp_err"]})["m"]}
                    state = {k: unflatten(start[k], [
                        rules.local_slice(t, sp, mesh).contiguous().to(device)
                        for t, sp in zip(leaves(start[k]), _spec_leaves(specs[k]))]) for k in specs}
                    state["step"] = start["step"].to(device)
                    mstep = make_train_step(cfg, opt, hp)
                whole, rows, launched = to_device(start, device), [], 0
                for b in batches:
                    want, metrics = step(whole, b)
                    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
                    with ctx():
                        threshes.clear()
                        if device == "cuda":
                            torch.cuda.synchronize()
                        reset_all_launches()
                        state, metrics = mstep(state, shard_batch(b))
                        if device == "cuda":
                            torch.cuda.synchronize()
                        launched += BULK_ENGINES["binomial"].kernels.launches["lookup_vec"]
                        row = compress_blocks(state, want, specs, kind, mesh, threshes)
                        row.update(loss=(float(metrics["loss"]), loss),
                                   norm=(float(metrics["grad_norm"]), norm))
                        rows.append(row)
                        whole = gather_state(state, start, specs, mesh, device)
                    del want
                del whole
                out[f"{name}/{kind}"] = {"steps": rows, "lookup_router": launched}
    finally:
        C.kth_magnitude = select
    return out


def compress_ranks(card: str, device: str = "cuda") -> int:
    """Part (b): ``MESH_TRAIN_RANKS`` gloo ranks sharing the card, each
    step of each case gated as ``compress_blocks`` says.  -> the
    lookup_router launches of the meshed steps, summed over the ranks."""
    t0 = time.perf_counter()
    ranks = run_ranks("compress_rank_body", device, "compress (b)")
    worst, flips, total = {}, {}, 0
    for rank, res in enumerate(ranks):
        for name, arch, lay, over in COMPRESS_CASES:
            for kind in COMPRESS_KINDS:
                row = res[f"{name}/{kind}"]
                want = 2 * 2 * 3 if over.get("router") == "hash" else 0  # forward + remat, 3 layers
                close = all(abs(p - q) <= tol * abs(q) for r in row["steps"]
                            for (p, q), tol in ((r["loss"], MESH_TRAIN_LOSS_TOL),
                                                (r["norm"], MESH_TRAIN_NORM_TOL)))
                good = all(r["flips_ok"] and r["rel_err"] <= COMPRESS_TOL
                           and r["flip_err"] <= COMPRESS_LR * 10 for r in row["steps"])
                if row["lookup_router"] != want or not close or not good:
                    fail(f"compress (b) rank {rank} {name} {kind}: {row} (lookup_router "
                         f"expected {want})")
                key = f"{name} {kind}"
                worst[key] = [max(a, r["rel_err"]) for a, r in
                              zip(worst.get(key, [0.0] * len(row["steps"])), row["steps"])]
                flips[key] = [r["flips"] for r in row["steps"]]  # the same on every rank
                total += row["lookup_router"]
    print(f"phase 3 compress (b): {MESH_TRAIN_RANKS} gloo ranks sharing {card}, (2, 2) mesh, "
          f"fsdp, float32 (TF32 off), 2 AdamW + master ZeRO-1 steps with each compression, "
          f"each against the unmeshed port's step on the card from the same state (step 2 "
          f"from the ranks' blocks after step 1): losses within {MESH_TRAIN_LOSS_TOL} and grad "
          f"norms within {MESH_TRAIN_NORM_TOL}; every rank's parameter, optimizer and residual "
          f"blocks within {COMPRESS_TOL} of their scale but for the elements whose compression "
          f"flipped (at most {COMPRESS_FLIP_SHARE} of a leaf, each int8 one quantum or topk "
          f"within {COMPRESS_NEAR} of the threshold, their state within "
          f"{COMPRESS_LR * 10:g}); largest departure by step "
          + ", ".join(f"{k} {' / '.join(f'{v:.2e}' for v in vs)}" for k, vs in worst.items())
          + "; flipped elements by step: "
          + ", ".join(f"{k} {' / '.join(str(v) for v in vs)}" for k, vs in flips.items())
          + f"; lookup_router {total // MESH_TRAIN_RANKS} launches a rank "
          f"({time.perf_counter() - t0:.1f} s)")
    return total


def phase_compress(card: str) -> tuple[dict, dict]:
    """Gradient compression under a mesh: (a) per engine the full-width
    cell with Adafactor under a one-rank NCCL mesh against unmeshed, (b)
    four gloo ranks on the reduced cases.  -> (launches by engine, the
    numbers of (a))."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    launches, numbers = {}, {}
    for engine in ENGINES:
        got = compress_full_width(card, engine)
        launches[engine] = {k: got.pop(k) for k in ("lookup_router", "radix_hist", "radix_pick")}
        numbers.update(got)
    dist.destroy_process_group()
    launches["binomial"]["lookup_router"] += compress_ranks(card)
    print(f"phase 3 compress: {time.perf_counter() - t0:.1f} s")
    return launches, numbers


# --- the placement path ------------------------------------------------------

#: the placement path's registered store (a realistic count of objects; the
#: 2^24-key pass is timed in phase 4) and the size of its CPU twin
STORE_KEYS = 1 << 20
TWIN_KEYS = 1 << 16
#: replicas failed by the storm, and repair copies per tick
STORM = 250
REPAIR_BUDGET = 4096


def placement_storyline(engine: str, device: str, n_keys: int) -> dict:
    """The placement path's storyline on ``device``: BatchRouter(1000,
    capacity 1024) with a LifecycleManager on a ManualClock, a
    StorePlacement(r = 3) holding ``n_keys`` keys and a PlacementRepairer.
    Every check fails the run; returns what the twin comparison and the
    report need."""
    from repro_torch.core.registry import make_bulk
    from repro_torch.placement.store import StorePlacement
    from repro_torch.serving.batch_router import BatchRouter
    from repro_torch.serving.lifecycle import LifecycleManager, ManualClock, PlacementRepairer

    tag = f"placement[{engine}] on {device}, {n_keys} keys"
    rng = np.random.default_rng(31)
    keys = rng.integers(0, 2**32, size=n_keys, dtype=np.uint32)
    clock = ManualClock()
    router = BatchRouter(1000, engine=engine, capacity=1024, device=device)
    mgr = LifecycleManager(router, clock=clock)
    hb = mgr.config.heartbeat
    kernels = make_bulk(engine).kernels
    store = StorePlacement(router, r=PLACE_R)
    t0 = time.perf_counter()
    store.register(keys)
    out = {"register_s": time.perf_counter() - t0}
    rep = PlacementRepairer(store, mgr, budget_per_tick=REPAIR_BUDGET)
    tasks: list = []
    tick = rep.tick

    def recording_tick(budget=None):  # also the batches the manager's ticks run
        done = tick(budget)
        tasks.extend(done)
        return done

    rep.tick = recording_tick
    copies = []
    to = router._fleet_host.to
    router._fleet_host.to = lambda dev: (copies.append(1), to(dev))[1]

    def beat(silent=()):
        for s in range(router.domain.total_count):
            if s not in silent:
                mgr.heartbeat(s)

    def settled(what):
        counts = store.reachable_counts()
        n_eff = min(PLACE_R, mgr.n_alive)
        if rep.backlog or (counts != n_eff).any():
            fail(f"{tag}: after {what} {int((counts != n_eff).sum())} keys are not on {n_eff} "
                 f"distinct live copies (backlog {rep.backlog})")

    def launched(fn):
        before = [kernels.launches[k] for k in PLACEMENT_KINDS]
        result = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return result, tuple(kernels.launches[k] - n for k, n in zip(PLACEMENT_KINDS, before))

    # two replicas fall silent past fail_after
    first = [int(s) for s in rng.choice(999, size=2, replace=False)]
    beat()
    clock.advance(hb.fail_after + 1)
    beat(first)
    events = mgr.tick()
    if [(e.kind, e.slot) for e in events] != [("fail", s) for s in sorted(first)]:
        fail(f"{tag}: two silent replicas gave events {events}")
    rep.quiesce()
    settled("two failures")
    snap = mgr.snapshot()  # mid-run
    # the storm: STORM more replicas fall silent at once
    alive = [s for s in range(999) if s not in first]
    storm = sorted(int(s) for s in rng.choice(alive, size=STORM, replace=False))
    before, n_before, n_copies, lost0 = store._synced_fleet, mgr.n_alive, len(copies), rep.lost
    clock.advance(hb.fail_after + 1)
    beat(set(first) | set(storm))
    t0 = time.perf_counter()
    events = mgr.tick()
    out["storm_tick_s"] = time.perf_counter() - t0
    out["storm_uploads"] = len(copies) - n_copies
    if [(e.kind, e.slot) for e in events] != [("fail", s) for s in storm] or out["storm_uploads"] != 1:
        fail(f"{tag}: the storm tick gave {len(events)} events and {out['storm_uploads']} uploads")
    plan, out["plan_launches"] = launched(lambda: store.plan_migration(before))
    out["moved_fraction"] = plan.moved_fraction
    out["delta_over_n"] = STORM / n_before
    t0 = time.perf_counter()
    triples = store.sync_targets()
    out["sync_targets_s"] = time.perf_counter() - t0
    out["sync_targets_triples"] = len(triples)
    dead = int((store.reachable_counts() == 0).sum())
    t0 = time.perf_counter()
    done = rep.quiesce()
    out["quiesce_s"] = time.perf_counter() - t0
    out["storm_copies"] = done
    out["storm_lost"] = rep.lost - lost0
    counts = store.reachable_counts()
    if out["storm_lost"] != PLACE_R * dead or ((counts != PLACE_R) & (counts != 0)).any() \
            or int((counts == 0).sum()) != dead:
        fail(f"{tag}: after the storm {dead} keys had every holder down and {out['storm_lost']} "
             f"tasks were lost; reachable counts {np.bincount(counts).tolist()}")
    out["lost_keys"] = dead
    for s in (snap, None):
        mgr.verify_replay(s)
        rep.verify_placement_replay(s)
    # the failed replicas beat again and are readmitted after readmit_after
    recovered = []
    for _ in range(int(hb.readmit_after) + 3):
        beat()
        recovered += [e.slot for e in mgr.tick() if e.kind == "recover"]
        clock.advance(hb.heartbeat_interval)
    if sorted(recovered) != sorted(first + storm):
        fail(f"{tag}: {len(recovered)} of {len(first) + STORM} replicas readmitted")
    rep.quiesce()
    settled("readmission")
    mgr.scale_up()
    rep.quiesce()
    settled("scale-up")
    mgr.scale_down()
    rep.quiesce()
    settled("scale-down")
    mgr.verify_replay()
    rep.verify_placement_replay()
    batch, out["place_launches"] = launched(lambda: store.place(keys))
    out.update(journal=mgr.journal.to_jsonl(), placement=batch.replicas, holders=store.holders.copy(),
               tasks=[dataclasses.astuple(t) for t in tasks], lost=rep.lost,
               completed=rep.completed, epoch=mgr.epoch, n_alive=mgr.n_alive)
    return out


def phase_placement() -> tuple[dict, dict]:
    """The placement path for both engines at ``STORE_KEYS`` keys on the
    card (launch counts set to 0 just before, read just after), then the
    same storyline at ``TWIN_KEYS`` keys on the card and on the CPU, which
    must agree -> (launches, the 2^20-key runs' host numbers)."""
    from repro_torch.core.registry import BULK_ENGINES

    launches, host = {}, {}
    for engine in ENGINES:
        for eng in BULK_ENGINES.values():
            eng.kernels.reset_launches()
        run = placement_storyline(engine, "cuda", STORE_KEYS)
        torch.cuda.synchronize()
        counts = BULK_ENGINES[engine].kernels.launches
        launches[engine] = {k: counts[k] for k in PLACEMENT_KINDS}
        host[engine] = {k: v for k, v in run.items() if isinstance(v, (int, float, tuple))}
        if launches[engine]["place"] == 0 or run["place_launches"] != (0, 0, 1) \
                or run["plan_launches"] != (0, 0, 2):
            fail(f"placement[{engine}]: launches {launches[engine]}, per place "
                 f"{run['place_launches']}, per plan_migration {run['plan_launches']}")
        print(f"phase 3 placement[{engine}]: {STORE_KEYS} keys on {PLACE_R} distinct live copies of "
              f"1000 replicas (capacity 1024); 2 then {STORM} replicas silent past fail_after: the "
              f"storm tick {run['storm_tick_s']:.3f} s with {run['storm_uploads']} upload and {STORM} "
              f"journaled fails; plan_migration moved fraction {run['moved_fraction']:.4f} (delta/n "
              f"{run['delta_over_n']:.4f}); sync_targets {run['sync_targets_s']:.3f} s for "
              f"{run['sync_targets_triples']} triples; quiesce {run['storm_copies']} copies in "
              f"{run['quiesce_s']:.3f} s ({run['storm_copies'] / run['quiesce_s']:.0f} copies/s), "
              f"{run['lost_keys']} keys with every holder down ({run['storm_lost']} tasks lost); "
              f"replays from a mid-run snapshot and genesis equal; {STORM + 2} readmitted, scale up, "
              f"scale down; epoch {run['epoch']}, {run['completed']} copies, {run['lost']} lost in all")
        print(f"phase 3 placement[{engine}] launches " + json.dumps(
            {f"{k}[{engine}]": n for k, n in launches[engine].items()})
            + f" (per place {run['place_launches']}, per plan_migration {run['plan_launches']})")
        twins = [placement_storyline(engine, device, TWIN_KEYS) for device in ("cuda", "cpu")]
        for key in ("journal", "placement", "holders", "tasks", "lost", "completed"):
            a, b = (t[key] for t in twins)
            if not (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b):
                fail(f"placement[{engine}] at {TWIN_KEYS} keys: {key} on the card differs from the CPU")
        print(f"phase 3 placement[{engine}] at {TWIN_KEYS} keys, card against CPU (plain versions): "
              f"identical journal ({len(twins[0]['journal'])} bytes), placement rows, holders, "
              f"{len(twins[0]['tasks'])} repair tasks, lost {twins[0]['lost']}, completed "
              f"{twins[0]['completed']}")
    return launches, host


# --- the streaming path -----------------------------------------------------

#: the streaming path's traffic: the reference's serving-bench shape
#: (BENCH_serving.json: 8 tenants, max_batch 64), 2^16 requests, then 2^12
#: hedged reads; a request's deadline is this far past its arrival
STREAM_REQUESTS = 1 << 16
STREAM_TENANTS = 8
STREAM_READS = 1 << 12
STREAM_SLO_US = 50_000


def streaming_path(engine: str) -> dict:
    """The streaming path on the card: ``StreamingFrontEnd`` (``WallClockUs``,
    the default ``StreamConfig``) over ``BatchRouter(1000, capacity=1024)``
    with a ``LifecycleManager`` (detector on a ``ManualClock``), a
    ``StorePlacement(r=3)`` of 2^20 registered keys, a ``PlacementRepairer``
    and a ``LoadMonitor`` (the default ``LoadConfig``); 2^16 requests from 8
    tenants submitted and pumped, ``STORM`` replicas silent halfway, then
    2^12 hedged reads.  The kernels' launch counts are set to 0 just before
    the requests and read just after.  Every check fails the run."""
    import copy

    from repro_torch.core.registry import BULK_ENGINES
    from repro_torch.observability import LoadConfig, LoadMonitor, expected_peak_over_mean
    from repro_torch.placement.store import StorePlacement
    from repro_torch.serving.batch_router import BatchRouter
    from repro_torch.serving.lifecycle import (
        AdmissionRejectedError, LifecycleManager, ManualClock, PlacementRepairer)
    from repro_torch.serving.streaming import StreamingFrontEnd, StreamRequest, WallClockUs

    tag = f"streaming[{engine}]"
    rng = np.random.default_rng(41)
    detector_clock, wall = ManualClock(), WallClockUs()
    router = BatchRouter(1000, engine=engine, capacity=1024)
    mgr = LifecycleManager(router, clock=detector_clock)
    store = StorePlacement(router, r=PLACE_R)
    store.register(rng.integers(0, 2**32, size=STORE_KEYS, dtype=np.uint32))
    PlacementRepairer(store, mgr, budget_per_tick=REPAIR_BUDGET)
    fe = StreamingFrontEnd(mgr, store=store, clock=wall)
    alarms: list = []
    mon = LoadMonitor(router, metrics=fe.metrics, on_alarm=alarms.append)
    probes = []
    route_probes = mon.tracker._route_probes
    mon.tracker._route_probes = lambda: (probes.append(1), route_probes())[1]
    for s in range(1000):
        mgr.heartbeat(s)
    storm = {int(s) for s in rng.choice(999, size=STORM, replace=False)}
    keys = rng.integers(0, 2**32, size=STREAM_REQUESTS, dtype=np.uint64).tolist()
    domains = {mgr.epoch: copy.deepcopy(router.domain)}
    kernels = BULK_ENGINES[engine].kernels
    for eng in BULK_ENGINES.values():
        eng.kernels.reset_launches()
    results = []
    t0 = time.perf_counter()
    for i, key in enumerate(keys):
        if i == STREAM_REQUESTS // 2:  # the storm: STORM replicas fall silent
            detector_clock.advance(mgr.config.heartbeat.fail_after + 1)
            for s in range(router.domain.total_count):
                if s not in storm:
                    mgr.heartbeat(s)
        try:
            fe.submit(StreamRequest(key=key, deadline_us=wall.now_us() + STREAM_SLO_US,
                                    tenant=f"t{i % STREAM_TENANTS}"))
        except AdmissionRejectedError:
            pass  # counted by the registry's shed series
        results += fe.pump()
    results += fe.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    mon.drain()
    domains[mgr.epoch] = copy.deepcopy(router.domain)
    stats = fe.stats()
    wrong = sum(domains[r.epoch].locate(r.request.key) != r.replica for r in results)
    if wrong or set(domains) != {r.epoch for r in results} or len(domains) != 2:
        fail(f"{tag}: {wrong} served replicas differ from the scalar oracle at their epoch "
             f"(epochs {sorted({r.epoch for r in results})}, journal {sorted(domains)})")
    if not (stats["served"] == len(results) == fe.tracer.count("request") == mon.total_keys) \
            or stats["served"] + stats["shed_total"] != STREAM_REQUESTS:
        fail(f"{tag}: served {stats['served']}, consumed {len(results)}, request spans "
             f"{fe.tracer.count('request')}, drained keys {mon.total_keys}, shed {stats['shed_total']}")
    cfg = mon.config
    ratio = mon.peak_over_mean()
    envelope = cfg.balance_mult * expected_peak_over_mean(mon.total_keys, mgr.n_alive)
    if alarms or ratio is None or ratio > envelope:
        fail(f"{tag}: alarms {alarms}, peak/mean {ratio} against the envelope {envelope}")
    if launches["route_load"] != stats["dispatches"] or launches["route"] != len(probes):
        fail(f"{tag}: {launches['route_load']} route_load launches for {stats['dispatches']} "
             f"dispatches, {launches['route']} route launches for {len(probes)} probe re-routes")
    # hedged reads of keys with a live copy
    live = np.flatnonzero(store.reachable_counts() > 0)
    picks = rng.choice(live, size=STREAM_READS, replace=False)
    t1 = time.perf_counter()
    reads = [fe.read(int(ki)) for ki in picks]
    read_s = time.perf_counter() - t1
    alive = set(range(router.domain.total_count)) - set(router.domain.removed)
    bad = sum(r.shard not in r.holders or r.shard not in alive
              or r.shard not in store.holders[r.key_index].tolist() for r in reads)
    if bad:
        fail(f"{tag}: {bad} of {STREAM_READS} reads returned no holder")
    lat = np.asarray([r.latency_us for r in results])
    # the front end's own host work: the breaker board's walk over the
    # detector's slots (every pump and read) and one lifecycle tick (every
    # dispatch), at this fleet size
    observe_ms = host_ms(fe.breakers.observe, 200)
    tick_ms = host_ms(mgr.tick, 200)
    # host time per launch of a serve-size batch, instrumented against bare
    batch = torch.from_numpy(np.asarray(keys[:64], np.uint32).view(np.int32)).cuda()
    LoadMonitor(router, config=LoadConfig(drain_every=1 << 30))
    inst_ms = host_ms(lambda: router.route_keys(batch), 2000)
    router.detach_load_monitor()
    bare_ms = host_ms(lambda: router.route_keys(batch), 2000)
    return dict(requests=STREAM_REQUESTS, served=stats["served"], shed=stats["shed_total"],
                dispatches=stats["dispatches"], wall_s=wall_s, requests_per_s=len(results) / wall_s,
                p50_us=float(np.percentile(lat, 50)), p99_us=float(np.percentile(lat, 99)),
                reads=len(reads), hedged=stats["hedge_launched"], read_s=read_s,
                peak_over_mean=ratio, envelope=envelope, epochs=sorted(domains),
                probe_reroutes=len(probes), drains=mon.drains, launches=launches,
                host_us_instrumented=inst_ms * 1e3, host_us_bare=bare_ms * 1e3,
                host_us_breaker_observe=observe_ms * 1e3, host_us_tick=tick_ms * 1e3,
                lost_keys=int(STORE_KEYS - live.size))


def streaming_storyline(engine: str, device: str, kind: str) -> tuple:
    """``tests/chaos.py``'s streaming storylines, cut down, on one
    ``VirtualClockUs`` with an injected service model: ``overload`` ramps the
    offered load from half to 4x capacity (then a failure mid-stream and its
    recovery), ``latency_spike`` scripts a service spike and a flapping shard
    (breakers, hedged reads), then an outage and the shard's return ->
    (the results, the registry/trace/monitor JSON bytes, the drained
    windows), which must not depend on the device."""
    from repro_torch import observability as O
    from repro_torch.placement.store import StorePlacement
    from repro_torch.serving import lifecycle as L
    from repro_torch.serving import streaming as S
    from repro_torch.serving.batch_router import BatchRouter

    rng = np.random.default_rng(53)
    clock = S.VirtualClockUs()
    router = BatchRouter(12, engine=engine, device=device)
    hb = L.HeartbeatConfig(heartbeat_interval=0.05, suspect_after=0.15, fail_after=0.35,
                           readmit_after=0.2)
    mgr = L.LifecycleManager(router, L.LifecycleConfig(heartbeat=hb), clock=clock.seconds_view())
    store = StorePlacement(router, r=3)
    store.register(rng.integers(0, 2**32, size=256, dtype=np.uint32))
    L.PlacementRepairer(store, mgr, budget_per_tick=64)
    reg, trace = O.MetricsRegistry(clock=clock), O.SpanTrace(capacity=1 << 15)
    mon = O.LoadMonitor(router, metrics=reg, config=O.LoadConfig(drain_every=1 << 30))
    spike = [1.0]
    out, windows = [], []

    def frontend():
        def probe(shard):
            try:
                return 900 if mgr.detector.state_of(int(shard)) == L.SUSPECT else 120
            except KeyError:
                return 120

        return S.StreamingFrontEnd(
            mgr, store=store, config=S.StreamConfig(max_batch=16, service_bound_us=2_000),
            clock=clock, breaker_config=S.BreakerConfig(cooldown_us=2_000_000),
            service_model=lambda n: min(int(800 * spike[0]), 2_000), probe=probe, metrics=reg,
            tracer=trace)

    def drive(fe, n, gap, slo):
        for _ in range(n):
            req = S.StreamRequest(key=int(rng.integers(0, 2**32)), deadline_us=clock.now_us() + slo,
                                  tenant=f"t{int(rng.integers(0, 4))}")
            try:
                fe.submit(req)
            except L.AdmissionRejectedError as e:
                out.append(("shed", e.reason))
            clock.advance_us(max(1, int(rng.uniform(0.8 * gap, 1.2 * gap))))
            out.extend(fe.pump())
        out.extend(fe.drain())
        for ki in rng.integers(0, 256, size=4).tolist():
            try:
                out.append(fe.read(ki))
            except L.FleetUnavailableError:
                out.append(("unreadable", ki))

    def beat(skip=None):
        for s in mgr.detector.slots:
            if s != skip:
                mgr.heartbeat(s)

    if kind == "overload":
        for mult in (0.5, 1.0, 2.0, 4.0):
            drive(frontend(), 240, max(1, int(50 / mult)), 4_000)
        windows.append(mon.drain())
        mgr.fail(5)
        drive(frontend(), 80, 100, 4_000)
        windows.append(mon.drain())
        mgr.recover(5)
    else:
        fe, victim = frontend(), 4
        for rnd in range(28):
            beat(skip=victim if 6 <= rnd < 22 and rnd % 4 else None)
            spike[0] = 2.5 if 10 <= rnd < 18 else 1.0
            drive(fe, 10, 100, 5_000)
            clock.advance_us(50_000)
            out.extend(fe.pump())
        for silent in (True,) * 10 + (False,) * 12:  # an outage, then the return
            beat(skip=victim if silent else None)
            drive(fe, 8, 100, 5_000)
            clock.advance_us(50_000)
            out.extend(fe.pump())
        out.append(fe.stats())
        windows.append(mon.drain())
    rows = [r if isinstance(r, (tuple, dict)) else dataclasses.astuple(r) for r in out]
    return rows, O.to_json(reg, trace=trace, monitor=mon), [w.tolist() for w in windows]


def phase_streaming() -> tuple[dict, dict]:
    """The streaming path for both engines (launch counts set to 0 just
    before the requests, read just after), then ``streaming_storyline``'s
    two kinds on the card and on the CPU, which must agree -> (launches,
    numbers)."""
    launches, numbers = {}, {}
    for engine in ENGINES:
        run = streaming_path(engine)
        launches[engine] = {k: n for k, n in run.pop("launches").items() if n}
        numbers[engine] = run
        print(f"phase 3 streaming[{engine}]: {run['requests']} requests from {STREAM_TENANTS} tenants "
              f"(max_batch 64, max_wait 1000 us, WallClockUs) on 1000 replicas (capacity 1024), "
              f"{STORE_KEYS} keys on {PLACE_R} copies, {STORM} replicas silent halfway: served "
              f"{run['served']}, shed {run['shed']}, {run['dispatches']} dispatches in "
              f"{run['wall_s']:.3f} s = {run['requests_per_s']:.0f} requests/s, latency p50 "
              f"{run['p50_us']:.0f} us, p99 {run['p99_us']:.0f} us; every replica the scalar "
              f"oracle's at its epoch {run['epochs']}; {run['drains']} drains, drained keys = served, "
              f"peak/mean {run['peak_over_mean']:.4f} inside the envelope {run['envelope']:.4f}, no "
              f"alarm; {run['probe_reroutes']} probe re-routes; {run['reads']} hedged reads "
              f"({run['hedged']} hedged) each from a live holder in {run['read_s']:.3f} s; host per "
              f"64-key route_keys: instrumented {run['host_us_instrumented']:.2f} us, bare "
              f"{run['host_us_bare']:.2f} us; host per breaker observe (every pump) "
              f"{run['host_us_breaker_observe']:.1f} us, per lifecycle tick (every dispatch) "
              f"{run['host_us_tick']:.1f} us")
        print(f"phase 3 streaming[{engine}] launches " + json.dumps(
            {f"{k}[{engine}]": n for k, n in launches[engine].items()}))
        for kind in ("overload", "latency_spike"):
            card, cpu = (streaming_storyline(engine, device, kind) for device in ("cuda", "cpu"))
            for name, a, b in zip(("results", "JSON bytes", "drained windows"), card, cpu):
                if a != b:
                    fail(f"streaming[{engine}] {kind}: {name} on the card differ from the CPU's")
            print(f"phase 3 streaming[{engine}] {kind} storyline on a VirtualClockUs, card against "
                  f"CPU: identical {len(card[0])} results, sheds and reads, {len(card[1])} JSON bytes, "
                  f"drained windows summing to {sum(map(sum, card[2]))} keys")
    return launches, numbers


# --- the examples -------------------------------------------------------------

#: the port's examples (``examples/<name>_torch.py``), as the JAX package's
EXAMPLES = ("quickstart", "serve_lm", "train_lm", "elastic_cluster", "placement_demo",
            "observability_demo", "streaming_demo")


def example_lines(text: str) -> list:
    """An example's printed lines, masked by ``examples/example_output.py``
    (times, the device and the numbers that follow the random weights, drawn
    from a generator on the run's device), as the CPU tests compare the
    port's examples with the JAX package's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("example_output",
                                                  ROOT / "examples" / "example_output.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.normalize(text)


def run_example(name: str, device: str) -> tuple[str, float]:
    """``examples/<name>_torch.py``'s ``main(["--device", device])`` in
    this process: (what it printed, seconds)."""
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  ROOT / "examples" / f"{name}_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        module.main(["--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    return out.getvalue(), time.perf_counter() - t0


def phase_examples(card: str) -> dict:
    """Each of the seven examples on the card, the kernels' launch counts
    set to 0 just before it and read just after, then on the CPU: the two
    outputs equal line for line but for ``example_lines``' masks; the
    quickstart's kernel must match its plain path -> launches by engine."""
    from repro_torch.core.registry import BULK_ENGINES

    launches = {engine: {} for engine in ENGINES}
    for name in EXAMPLES:
        reset_all_launches()
        on_card, card_s = run_example(name, "cuda")
        ran = {engine: {k: n for k, n in BULK_ENGINES[engine].kernels.launches.items() if n}
               for engine in ENGINES}
        on_cpu, cpu_s = run_example(name, "cpu")
        a, b = example_lines(on_card), example_lines(on_cpu)
        if a != b:
            diff = [f"{x!r} | {y!r}" for x, y in zip(a, b) if x != y][:4]
            fail(f"examples: {name} on the card printed {len(a)} lines, on the CPU {len(b)}; "
                 f"they differ: {diff}")
        if name == "quickstart" and "cuda kernel     : matches plain path = True" not in on_card:
            fail("examples: the quickstart's CUDA kernel does not match its plain path")
        for engine, counts in ran.items():
            for kind, n in counts.items():
                launches[engine][kind] = launches[engine].get(kind, 0) + n
        print(f"phase 3 examples {name}: {len(a)} lines equal on the card and the CPU (times, "
              f"device and weight-dependent numbers masked); card {card_s:.1f} s, CPU "
              f"{cpu_s:.1f} s; launches " + json.dumps(
                  {f"{k}[{e}]": n for e, c in ran.items() for k, n in c.items()}) + f"; on {card}")
    return launches


# --- times and bounds -------------------------------------------------------


def trip_counts(engine, keys, n):
    """Per key: loop iterations, whether the loop leaves through binomial's
    fold (block A or C), whether the lookup needs that fold (not on the
    first trip, where it equals the candidate), and the bucket the loop
    settles on, for ``n`` buckets.  The bucket is held against the plain
    lookup, so the trip counts follow the same loop."""
    from repro_torch.core import binomial_torch as bt

    k = bt.u32(keys)
    n = bt.u32(n)
    iters = torch.full_like(k, 16)
    fold = torch.zeros_like(k, dtype=torch.bool)
    needed = torch.zeros_like(fold)
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
            if i:
                needed = needed | (stop & (c < M))
            bucket = torch.where(stop & (c >= M), c, bucket)
            done = done | stop
            kacc = (kacc + bt.GOLDEN32) & bt.MASK32
            hi = bt.mix32(kacc)
        fold, needed = fold | ~done, needed | ~done
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
    return iters, fold, needed, torch.where(n <= 1, 0, bucket)


def time_ms(fn, launches: int = 10, repeats: int = 5) -> float:
    """Device time per launch of ``fn``, a call that keeps the card busier
    than the host's enqueue: CUDA events around ``launches`` back-to-back
    calls, median over ``repeats``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


#: clock cycles a sleeping kernel holds the stream (~25 ms at 1.98 GHz)
SLEEP_CYCLES = 50_000_000


def small_call_ms(fn, launches: int = 200, repeats: int = 5) -> tuple[float, bool]:
    """Device time per launch of a call too small to outlast its own host
    enqueue: the launches are queued behind a sleeping kernel, so once it
    wakes the card runs them back to back, and the events bracket only
    them.  -> (ms per launch, whether every enqueue finished within the
    sleep, without which the time would be the host's)."""
    fn()
    torch.cuda.synchronize()
    times, held = [], True
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        held = held and host_ms < ev[0].elapsed_time(ev[1])
        times.append(ev[1].elapsed_time(ev[2]) / launches)
    return statistics.median(times), held


def host_ms(fn, calls: int = 1000) -> float:
    """The wrapper's host time per call: ``perf_counter`` over ``calls``
    calls, then one synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def bound(engine, kind, keys, fleet, n_vec: int = VEC_N_TIME, nbytes: int | None = None) -> dict:
    """The least time the card could take for ``kind`` on these keys: the
    larger of ``WORK``'s SASS lane instructions for the trips this data
    needs (at the issue rate) and the bytes the call must move (at the HBM
    rate; ``nbytes`` where its inputs are not the keys).  Also the same
    bound by the first build's ``YARDSTICK``.  The static-n lookup takes ``n_vec`` as
    a launch argument and reads no fleet."""
    from repro_torch.core import binomial_torch as bt
    from repro_torch.core.registry import make_bulk

    kernels = make_bulk(engine).kernels
    count = keys.numel()
    n = fleet.state[0] if kind != "lookup_vec" else torch.tensor(n_vec, device=keys.device)
    iters, fold, needed, settled = trip_counts(engine, keys, n)
    if kind == "lookup_vec":
        routed = kernels.lookup_vec_plain(keys, n_vec)
    else:
        routed = kernels.lookup_dyn_plain(keys.to(torch.int32), fleet.state[:1])
    if not torch.equal(settled, routed.to(torch.int64)):
        fail(f"the trip counts of {kind}[{engine}] follow another loop than the plain lookup")
    trips = int(iters.sum())
    per = {}
    for name, table, folds in (("work", WORK, needed), ("yardstick", YARDSTICK, fold)):
        c = table[engine, kind]
        per[name] = c["key"] * count + c["iter"] * trips + c["fold"] * int(folds.sum())
    if nbytes is None:
        nbytes = BYTES_PER_KEY[kind] * count
    # one thread per key (the yardstick's layout): a warp of 32 consecutive
    # keys runs as many trips as its slowest lane
    flat = iters.reshape(-1)
    whole = count // 32 * 32
    warp_trips = flat[:whole].reshape(-1, 32).max(1).values if whole else flat.max().reshape(1)
    diverted = 0.0
    if kind in ("route", "ingest"):
        b = bt.u32(routed)
        hit = ((bt.u32(fleet.packed)[b >> 5] >> (b & 31)) & 1) != 0
        q = bt.mulhi32(bt.hash_pair(bt.u32(keys), b), bt.u32(fleet.state[0]))
        deep = hit & (q >= bt.u32(fleet.state[1]))
        for name, table in (("work", WORK), ("yardstick", YARDSTICK)):
            c = table[engine, kind]
            per[name] += c["divert"] * int(hit.sum()) + c["deep"] * int(deep.sum())
        diverted = float(hit.double().mean())
        nbytes += 4 * (fleet.packed.numel() + fleet.table.numel() + fleet.state.numel())
    elif kind == "lookup_dyn":
        nbytes += 4  # n
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = {name: ops / hw.LANE_INSTR_S * 1e3 for name, ops in per.items()}
    return dict(bound_ms=max(t_ops["work"], t_bytes),
                bound_by="operations" if t_ops["work"] >= t_bytes else "bytes",
                yardstick_bound_ms=max(t_ops["yardstick"], t_bytes), t_ops=t_ops["work"],
                t_bytes=t_bytes, per_key=per["work"] / count,
                yardstick_per_key=per["yardstick"] / count,
                trips=float(flat.double().mean()), warp_trips=float(warp_trips.double().mean()),
                first_trip=float((flat == 1).double().mean()),
                folds=float(needed.double().mean()), diverted=diverted)


def trips_text(b: dict) -> str:
    """This data's loop trips: per key, per warp of 32 consecutive keys (one
    thread per key), the share of keys settled on the first trip, the share
    that needs binomial's fold, and the share of keys diverted."""
    return (f"mean trips {b['trips']:.3f} per key, {b['warp_trips']:.3f} per warp of 32 keys, "
            f"{b['first_trip']:.1%} settled on the first trip"
            + (f", {b['folds']:.2%} need the fold" if b["folds"] else "")
            + (f", {b['diverted']:.1%} diverted" if b["diverted"] else ""))


def share(bound_ms: float, ms: float) -> str:
    """bound / time; above 1 the kernel did the work in fewer instructions
    than the bound counts."""
    r = bound_ms / ms
    return f"{r:.3f}" + (" (above 1: fewer instructions than the bound counts)" if r > 1 else "")


def bound_text(b: dict, ms: float) -> str:
    return (f"bound {b['bound_ms']:.4f} ms (instructions {b['t_ops']:.4f} ms = "
            f"{b['per_key']:.1f}/key, {trips_text(b)}; bytes {b['t_bytes']:.4f} ms), bound/time "
            f"{share(b['bound_ms'], ms)}; by the first build's yardstick {b['yardstick_bound_ms']:.4f} ms "
            f"({b['yardstick_per_key']:.1f}/key), bound/time {share(b['yardstick_bound_ms'], ms)}")


def bound_row(b: dict) -> dict:
    return dict(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                yardstick_bound_ms=b["yardstick_bound_ms"])


def phase_times(serve_calls: dict, moe_cfg) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import binomial_torch as bt
    from repro_torch.core.registry import make_bulk

    rng = np.random.default_rng(2)
    keys = u32_tensor(rng, N_TIME).cuda()
    hi = u32_tensor(rng, N_TIME).cuda()
    vocab = get_config(SERVE_ARCH).vocab_size
    tokens_big = torch.from_numpy(rng.integers(0, vocab, size=N_TIME // moe_cfg.top_k)).cuda()
    rows = {}
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        plane, fleet = make_fleet(engine, 1000, 1024, 250, 2)
        for kind in KINDS:
            src = bt.mix64_lo32(keys, hi) if kind == "ingest" else keys
            b = bound(engine, kind, src, fleet)
            ms = time_ms(lambda: run_kind(kernels, kind, keys, hi, fleet, plain=False))
            plain_ms = time_ms(lambda: run_kind(kernels, kind, keys, hi, fleet, plain=True), 1, 3)
            rows[engine, kind] = dict(ms=ms, plain_ms=plain_ms, **bound_row(b))
            what = f"n = {VEC_N_TIME}" if kind == "lookup_vec" else "fleet 1000/1024 with 250 failed"
            print(f"phase 4 {kind}[{engine}] {N_TIME} keys, {what}: "
                  f"{ms:.4f} ms ({N_TIME / ms / 1e6:.3f} Gkeys/s), {bound_text(b, ms)}, "
                  f"plain version {plain_ms:.3f} ms")
        # half the binomial keys continue past the first trip
        b = bound(engine, "lookup_vec", keys, None, VEC_N_HALF)
        ms = time_ms(lambda: kernels.lookup_vec(keys, VEC_N_HALF))
        rows[engine, "lookup_vec"].update({"n1025_ms": ms, "n1025_bound_ms": b["bound_ms"],
                                           "n1025_yardstick_bound_ms": b["yardstick_bound_ms"]})
        print(f"phase 4 lookup_vec[{engine}] {N_TIME} keys, n = {VEC_N_HALF}: {ms:.4f} ms, "
              f"{bound_text(b, ms)}")
        # the router's static-n lookup, keys built in the launch: at 2^24
        # router keys (the bound does not count the key build), then at the
        # serve path's largest group
        calls = {"2^24": (tokens_big, 3), **{p: c[engine] for p, c in serve_calls.items()}}
        for phase, (tokens, salt) in calls.items():
            args = (tokens, salt, moe_cfg.top_k, moe_cfg.num_experts, moe_cfg.router_hash_omega)
            vk = bt.router_keys(tokens, salt, moe_cfg.top_k)
            b = bound(engine, "lookup_vec", vk, None, moe_cfg.num_experts,
                      nbytes=tokens.numel() * tokens.element_size() + 4 * vk.numel())
            head = (f"phase 4 lookup_router[{engine}] token ids {tuple(tokens.shape)} -> "
                    f"{vk.numel()} router keys, n = {moe_cfg.num_experts}")
            if phase == "2^24":
                ms = time_ms(lambda: kernels.lookup_router(*args))
                plain_ms = time_ms(lambda: kernels.lookup_router_plain(*args), 1, 3)
                rows[engine, "lookup_router"] = dict(ms=ms, plain_ms=plain_ms, **bound_row(b))
                print(f"{head}: {ms:.4f} ms ({vk.numel() / ms / 1e6:.3f} Gkeys/s), "
                      f"{bound_text(b, ms)}, plain version {plain_ms:.3f} ms")
                continue
            ms, held = small_call_ms(lambda: kernels.lookup_router(*args))
            enqueue_ms = host_ms(lambda: kernels.lookup_router(*args))
            plain_ms = time_ms(lambda: kernels.lookup_router_plain(*args), 1, 11)
            rows[engine, "lookup_router"].update({
                f"{phase}_keys": vk.numel(), f"{phase}_ms": ms, f"{phase}_host_ms": enqueue_ms,
                f"{phase}_plain_ms": plain_ms, f"{phase}_bound_ms": b["bound_ms"]})
            print(f"{head}, the serve path's {phase} size: device {ms * 1e3:.2f} us per launch "
                  f"(launches queued back to back"
                  f"{'' if held else '; NOT all enqueued within the sleep: host-bound'}), "
                  f"wrapper host {enqueue_ms * 1e3:.2f} us per call, bound {b['bound_ms'] * 1e3:.4f} "
                  f"us ({b['bound_by']}), plain version {plain_ms:.3f} ms")
            if not held:
                fail(f"lookup_router[{engine}] at the {phase} size: the launches outlasted the sleep")
    return rows


def resolve_bound(keys, base, out, r: int, with_old: bool = False) -> dict:
    """The least time the card could take for ``resolve`` on these inputs:
    bytes (keys, the routed columns and the table read once, the columns
    and the exhausted flags written once, at the HBM rate) against a floor
    of its operations: per key one load or store per column read or written
    and one compare per pair of columns, and per collision (a column equal
    to an earlier one in ``base``) the re-salt hash (two fmix32 and a
    multiply-high, 12 operations) and one probe (a load, j compares, an
    add and a wrap, j + 4), at the issue rate.  With ``old`` (the migration
    diff) also the old columns read and the moved bytes written once, and
    per key a load and a store a column and r compares a column.  The floor
    counts the algorithm's operations, not the build's SASS."""
    n = keys.numel()
    pairs = r * (r - 1) // 2
    collisions = []  # per column j >= 1: the keys whose column j collides
    for j in range(1, r):
        hit = torch.zeros(n, dtype=torch.bool, device=base.device)
        for k in range(j):
            hit |= base[:, j] == out[:, k]
        collisions.append(int(hit.sum()))
    ops = n * (2 * r + 1 + pairs) + sum(c * (12 + j + 4) for j, c in enumerate(collisions, 1))
    nbytes = 4 * n + 4 * n * r * 2 + n + 4 * 1024
    if with_old:
        ops += n * r * (2 + r)
        nbytes += (4 + 1) * n * r
    t_ops, t_bytes = ops / hw.LANE_INSTR_S * 1e3, nbytes / hw.HBM_BW * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                t_ops=t_ops, t_bytes=t_bytes, collisions=collisions)


def registers(prefix: str) -> int:
    """The registers ptxas gave the kernel function whose mangled name
    starts with ``prefix`` (the library's ``-Xptxas -v`` log)."""
    from repro_torch.kernels import build

    lines = build.build().with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and f"'{prefix}" in line:
            for after in lines[i + 1:]:
                m = re.search(r"Used (\d+) registers", after)
                if m:
                    return int(m.group(1))
    fail(f"no register count for {prefix} in the ptxas log")


#: the fused placement's timed fleets (n, capacity, failed): the store
#: cells' 200 OSDs in 256, healthy and with 50 failed, and phase 4's 1000 in
#: 1024 with 250 failed (the ``place`` row's)
PLACE_TIME_FLEETS = {"200/256 healthy": (200, 256, 0), "200/256 50 failed": (200, 256, 50),
                     "1000/1024 250 failed": (1000, 1024, 250)}


def place_bound(engine, keys, fleet, r: int, out) -> dict:
    """The least time ``place`` could take on these keys: its bytes (a key
    read, r ids and the exhausted flag written, 4 + 4r + 1 B an object, and
    the fleet once, at the HBM rate) against its operations: ``bound``'s
    count for the route of the r family keys (``WORK``: a key's load and
    its bucket's store included) plus the resolution's, per object one
    compare per pair of columns and the flag's store, and per collision
    (``out``'s column equal to an earlier routed one) the re-salt hash and
    one probe, as ``resolve_bound`` counts them."""
    from repro_torch.core.placement_torch import family_keys
    from repro_torch.core.registry import make_bulk

    n = keys.numel()
    fkeys = family_keys(keys, r).reshape(-1)
    fb = bound(engine, "route", fkeys, fleet)
    kernels = make_bulk(engine).kernels
    base = kernels.route_family(keys, r, fleet.packed, fleet.table, fleet.state)
    collisions = [int((base[:, j:j + 1] == out[:, :j]).any(1).sum()) for j in range(1, r)]
    ops = n * (1 + r * (r - 1) // 2) + sum(c * (12 + j + 4) for j, c in enumerate(collisions, 1))
    t_ops = fb["t_ops"] + ops / hw.LANE_INSTR_S * 1e3
    nbytes = (4 + 4 * r + 1) * n + 4 * (fleet.packed.numel() + fleet.table.numel()
                                        + fleet.state.numel())
    t_bytes = nbytes / hw.HBM_BW * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                t_ops=t_ops, t_bytes=t_bytes, first_trip=fb["first_trip"],
                diverted=fb["diverted"], collisions=sum(collisions) / n)


def place_times(kernels, keys, fleet, r: int, rounds: int = 2) -> dict:
    """``place`` (one launch) against the family route and resolve it
    replaces (two launches), in turns: the median ms of each, alone and
    with ``old`` (the diff's second launch; its old rows this placement's,
    each row's columns rotated)."""
    args = (fleet.packed, fleet.table, fleet.state)
    old = kernels.place(keys, r, *args, 16, r)[0].roll(1, 1)  # each old row's columns rotated
    cases = {
        "place": lambda: kernels.place(keys, r, *args, 16, r),
        "pair": lambda: kernels.resolve(keys, kernels.route_family(keys, r, *args), fleet.table,
                                        fleet.state, r),
        "place_old": lambda: kernels.place(keys, r, *args, 16, r, old),
        "pair_old": lambda: kernels.resolve(keys, kernels.route_family(keys, r, *args),
                                            fleet.table, fleet.state, r, old),
    }
    got = {name: [] for name in cases}
    for _ in range(rounds):
        for name, fn in (*cases.items(), *reversed(cases.items())):
            got[name].append(time_ms(fn))
    return {name: statistics.median(v) for name, v in got.items()}


def phase_placement_times(rows: dict, card: str) -> None:
    """At 2^24 keys on the fleet of 1000 in capacity 1024: ``route_keys``
    healthy and with 250 failed (the storm/steady ratio); then with 250
    failed, r = 3: ``place_keys`` (``route_replicas_bulk``: one ``place``
    launch), the family route and resolve alone, and ``plan_migration``'s
    diff (``placement_diff_bulk``, healthy -> 250 failed, two launches),
    beside their bounds and the plain versions; then ``place`` against the
    family route and resolve it replaces, in turns, on ``PLACE_TIME_FLEETS``
    at r = 3, alone and with the old rows.  Adds the ``route_family``,
    ``resolve`` and ``place`` rows."""
    from repro_torch.core.bulk import PlacementSpec
    from repro_torch.core.placement_torch import family_keys
    from repro_torch.core.registry import make_bulk
    from repro_torch.kernels import ops
    from repro_torch.serving.batch_router import BatchRouter

    keys = u32_tensor(np.random.default_rng(2), N_TIME).cuda()
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        router = BatchRouter(1000, engine=engine, capacity=1024)
        healthy = router._fleet_dev
        steady = time_ms(lambda: router.route_keys(keys))
        victims = np.random.default_rng(2).choice(999, size=250, replace=False)
        with router.coalesced_events():
            for b in victims:
                router.fail(int(b))
        router._check_routable()
        storm = time_ms(lambda: router.route_keys(keys))
        rows[engine, "route"].update(route_keys_steady_ms=steady, route_keys_storm_ms=storm,
                                     storm_over_steady=storm / steady)
        print(f"phase 4 BatchRouter.route_keys[{engine}] {N_TIME} keys, 1000/1024: healthy "
              f"{steady:.4f} ms, 250 failed {storm:.4f} ms, storm/steady {storm / steady:.4f} on {card}")
        fleet = router._fleet_dev
        pspec = PlacementSpec(router=router.spec, r=PLACE_R)
        args = (fleet.packed, fleet.table, fleet.state)
        base = kernels.route_family(keys, PLACE_R, *args)
        out, _, _ = kernels.resolve(keys, base, fleet.table, fleet.state, PLACE_R)
        place = time_ms(lambda: ops.route_replicas_bulk(keys, fleet, pspec))
        fam = time_ms(lambda: kernels.route_family(keys, PLACE_R, *args))
        res = time_ms(lambda: kernels.resolve(keys, base, fleet.table, fleet.state, PLACE_R))
        plan = time_ms(lambda: ops.placement_diff_bulk(keys, healthy, fleet, pspec), 3)
        fam_plain = time_ms(lambda: kernels.route_family_plain(keys, PLACE_R, *args), 1, 3)
        res_plain = time_ms(lambda: kernels.resolve_plain(keys, base, fleet.table, fleet.state,
                                                          PLACE_R), 1, 3)
        fkeys = family_keys(keys, PLACE_R).reshape(-1)
        fb = bound(engine, "route", fkeys, fleet, nbytes=4 * keys.numel() + 4 * fkeys.numel())
        rb = resolve_bound(keys, base, out, PLACE_R)
        hb_base = kernels.route_family(keys, PLACE_R, healthy.packed, healthy.table, healthy.state)
        hb_out = kernels.resolve(keys, hb_base, healthy.table, healthy.state, PLACE_R)[0]
        hfb = bound(engine, "route", fkeys, healthy, nbytes=4 * keys.numel() + 4 * fkeys.numel())
        hrb = resolve_bound(keys, hb_base, hb_out, PLACE_R)
        # the second place also reads the old columns and writes the mask
        moved_bytes = (4 + 1) * fkeys.numel() / hw.HBM_BW * 1e3
        pb, hpb = place_bound(engine, keys, fleet, PLACE_R, out), place_bound(
            engine, keys, healthy, PLACE_R, hb_out)
        place_bound_ms = pb["bound_ms"]
        plan_bound = hpb["bound_ms"] + pb["bound_ms"] + moved_bytes
        rows[engine, "route_family"] = dict(ms=fam, plain_ms=fam_plain, **bound_row(fb),
                                            place_keys_ms=place, place_keys_bound_ms=place_bound_ms,
                                            plan_migration_ms=plan, plan_migration_bound_ms=plan_bound)
        rows[engine, "resolve"] = dict(ms=res, plain_ms=res_plain, bound_ms=rb["bound_ms"],
                                       bound_by=rb["bound_by"])
        print(f"phase 4 route_family[{engine}] {N_TIME} keys x r = {PLACE_R}, 1000/1024 with 250 "
              f"failed: {fam:.4f} ms, {bound_text(fb, fam)}, plain "
              f"version {fam_plain:.3f} ms")
        print(f"phase 4 resolve[{engine}] {N_TIME} keys x r = {PLACE_R}: {res:.4f} ms, "
              f"bound {rb['bound_ms']:.4f} ms ({rb['bound_by']}; operations "
              f"{rb['t_ops']:.4f} ms, bytes {rb['t_bytes']:.4f} ms), bound/time "
              f"{share(rb['bound_ms'], res)}, plain version {res_plain:.3f} ms")
        print(f"phase 4 place_keys[{engine}] (route_replicas_bulk, 1 launch) {N_TIME} keys, r = "
              f"{PLACE_R}: {place:.4f} ms, bound {place_bound_ms:.4f} ms, bound/time "
              f"{share(place_bound_ms, place)}; plan_migration's diff (placement_diff_bulk, 2 launches, "
              f"healthy -> 250 failed) {plan:.4f} ms, bound {plan_bound:.4f} ms, bound/time "
              f"{share(plan_bound, plan)}; on {card}")
        cells = {}
        for label, (n, cap, n_fail) in PLACE_TIME_FLEETS.items():
            _, f = make_fleet(engine, n, cap, n_fail, 2)
            t = place_times(kernels, keys, f, PLACE_R)
            placed = kernels.place(keys, PLACE_R, f.packed, f.table, f.state, 16, PLACE_R)[0]
            b = place_bound(engine, keys, f, PLACE_R, placed)
            cells[label] = dict(t, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                                t_ops=b["t_ops"], t_bytes=b["t_bytes"])
            print(f"phase 4 place[{engine}] {N_TIME} objects x r = {PLACE_R}, {label}: one launch "
                  f"{t['place']:.4f} ms against the family route + resolve {t['pair']:.4f} ms "
                  f"({t['pair'] / t['place']:.3f}x; in turns); with old {t['place_old']:.4f} against "
                  f"{t['pair_old']:.4f} ms ({t['pair_old'] / t['place_old']:.3f}x); bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}: operations {b['t_ops']:.4f} ms, bytes "
                  f"{b['t_bytes']:.4f} ms = 17 B an object; {b['first_trip']:.1%} of family keys "
                  f"settled on the first trip, {b['diverted']:.1%} diverted, {b['collisions']:.2%} "
                  f"of objects collide), bound/time {share(b['bound_ms'], t['place'])}; "
                  f"{N_TIME / t['place'] / 1e6:.3f} Gobjects/s on {card}")
        main = cells["1000/1024 250 failed"]
        place_plain = time_ms(lambda: kernels.place_plain(keys, PLACE_R, *args, 16, PLACE_R), 1, 3)
        rows[engine, "place"] = dict(ms=main["place"], plain_ms=place_plain,
                                     bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                                     fleets=cells)


#: the erasure-coded store's layout (racks, DataNodes a rack), its r (the
#: row path) and its DataNodes down (the benchmark's ``store-ec-rs63``)
RACKS_LAYOUT, RACKS_R, RACKS_FAILED = (20, 10), 9, 20


def node_route_bound(engine, keys, cols, fleet) -> dict:
    """The least time ``node_route`` could take on these keys and rack
    columns ``cols`` (N, r) over the device ``RackFleet``: its bytes (the key
    4, the rack columns read 4r and the DataNodes written 4r, 76 B a group
    at r = 9, and the racks' fleets once, at the HBM rate) against its
    operations, ``bound``'s count for the route of each column's node key
    over its rack's fleet (the lookup over the rack's slots and the
    divert), summed over the racks."""
    from repro_torch.core.bulk import FleetState
    from repro_torch.core.placement_torch import node_keys

    r = cols.shape[1]
    nk, flat = node_keys(keys, r).reshape(-1), cols.reshape(-1).to(torch.int64)
    t_ops = 0.0
    for g in torch.unique(flat).tolist():
        f = FleetState(fleet.packed[g], fleet.table[g], fleet.state[g], fleet.table.shape[1])
        t_ops += bound(engine, "route", nk[flat == g], f, nbytes=0)["t_ops"]
    nbytes = (4 + 8 * r) * keys.numel() + 4 * (fleet.packed.numel() + fleet.table.numel()
                                              + fleet.state.numel())
    t_bytes = nbytes / hw.HBM_BW * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                t_ops=t_ops, t_bytes=t_bytes, bytes_per_group=nbytes / keys.numel())


def phase_racks(rows: dict, max_err: dict, card: str) -> dict:
    """The erasure-coded store on the card: ``RACKS_LAYOUT`` with
    ``RACKS_FAILED`` DataNodes down, 2^24 block groups at r = ``RACKS_R``.
    ``place_keys`` once with the launch counts set to 0 just before it (the
    family route, ``resolve``'s row path and the node route: one each); then
    ``place`` over the rack fleet (two launches at r > 8) and ``node_route``
    over the racks' node fleets, each without and with ``old`` (the healthy
    layout's placement), against their plain versions on the same inputs,
    bit-exact; their times, the plain versions' and their bounds, and
    ``place_keys``'s.  Adds the ``node_route`` rows (``racks``: the rack
    level's ``place`` and the whole call) -> the launches of that one call,
    by engine."""
    from repro_torch.core.bulk import FailureDomains
    from repro_torch.core.registry import make_bulk
    from repro_torch.placement.store import StorePlacement
    from repro_torch.serving.batch_router import BatchRouter

    n_racks, per_rack = RACKS_LAYOUT
    r = RACKS_R
    keys = u32_tensor(np.random.default_rng(33), N_TIME).cuda()
    failed = np.random.default_rng(33).choice(n_racks * per_rack, RACKS_FAILED, replace=False)
    launches = {}
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        router = BatchRouter(n_racks * per_rack, engine=engine, capacity=256, omega=16)
        store = StorePlacement(router, r=r, domains=FailureDomains(n_racks, per_rack))
        healthy = router.racks_dev
        with router.coalesced_events():
            for d in failed:
                router.fail(int(d))
        fleet = router.racks_dev
        f, h = fleet.racks, healthy.racks
        torch.cuda.synchronize()
        for kind in kernels.launches:
            kernels.launches[kind] = 0
        nodes, exhausted = store.place_keys(keys)
        torch.cuda.synchronize()
        launches[engine] = {k: n for k, n in kernels.launches.items() if n}
        if launches[engine] != {"route_family": 1, "resolve": 1, "node_route": 1}:
            fail(f"place_keys[{engine}] over failure domains made {launches[engine]}")
        old_cols = kernels.place(keys, r, h.packed, h.table, h.state, 16, r)[0]
        old_nodes = kernels.node_route(keys, old_cols, healthy.packed, healthy.table,
                                       healthy.state, per_rack, 16)[0]
        errs, moved = {}, {}
        for label, old_c, old_n in (("", None, None), ("old", old_cols, old_nodes)):
            (cols, _, m_cols), e_route, e_res, e_place = check_placement(kernels, keys, f, r, r,
                                                                         old_c)
            nargs = (keys, cols, fleet.packed, fleet.table, fleet.state, per_rack, 16, old_n)
            got = kernels.node_route(*nargs)
            want = kernels.node_route_plain(*nargs)
            torch.cuda.synchronize()
            errs[label or "alone"] = (e_route, e_res, e_place, _max_err(got, want))
            if old_n is not None:
                moved = dict(racks=int(m_cols.sum()), nodes=int(got[1].sum()))
            if any(errs[label or "alone"]) or not torch.equal(got[0], nodes):
                fail(f"racks[{engine}] {label}: max |kernel - plain| {errs[label or 'alone']}, "
                     "or place_keys's DataNodes differ from the two kernels'")
        for kind, i in (("route_family", 0), ("resolve", 1), ("place", 2), ("node_route", 3)):
            max_err[engine, kind] = max(max_err.get((engine, kind), 0), *(e[i] for e in errs.values()))
        racks_of = torch.div(nodes, per_rack, rounding_mode="floor")
        if bool(exhausted.any()) or not bool(
                ((racks_of[:, :, None] == racks_of[:, None, :]).sum(dim=(1, 2)) == r).all()):
            fail(f"racks[{engine}]: a group exhausted or with two blocks in one rack")
        fargs = (f.packed, f.table, f.state, 16, r)
        nargs = (fleet.packed, fleet.table, fleet.state, per_rack, 16)
        t = {
            "node_route": time_ms(lambda: kernels.node_route(keys, cols, *nargs)),
            "node_route_old": time_ms(lambda: kernels.node_route(keys, cols, *nargs, old_nodes)),
            "place": time_ms(lambda: kernels.place(keys, r, *fargs)),
            "place_old": time_ms(lambda: kernels.place(keys, r, *fargs, old_cols)),
            "place_keys": time_ms(lambda: store.place_keys(keys)),
        }
        plain = {
            "node_route": time_ms(lambda: kernels.node_route_plain(keys, cols, *nargs), 1, 3),
            "node_route_old": time_ms(lambda: kernels.node_route_plain(keys, cols, *nargs,
                                                                       old_nodes), 1, 3),
            "place": time_ms(lambda: kernels.place_plain(keys, r, *fargs), 1, 3),
        }
        nb = node_route_bound(engine, keys, cols, fleet)
        nb_old = max(nb["t_ops"], nb["t_bytes"] + (4 + 1) * r * N_TIME / hw.HBM_BW * 1e3)
        pb = place_bound(engine, keys, f, r, cols)
        rows[engine, "node_route"] = dict(
            ms=t["node_route"], plain_ms=plain["node_route"], bound_ms=nb["bound_ms"],
            bound_by=nb["bound_by"], old_ms=t["node_route_old"],
            old_plain_ms=plain["node_route_old"], old_bound_ms=nb_old,
            racks=dict(layout=f"{n_racks}x{per_rack}, {RACKS_FAILED} failed", r=r,
                       place_ms=t["place"], place_plain_ms=plain["place"],
                       place_bound_ms=pb["bound_ms"], place_old_ms=t["place_old"],
                       place_keys_ms=t["place_keys"],
                       place_keys_bound_ms=pb["bound_ms"] + nb["bound_ms"], moved=moved,
                       launches=launches[engine]))
        print(f"phase 4 racks[{engine}] {N_TIME} groups x r = {r} over {n_racks}x{per_rack} with "
              f"{RACKS_FAILED} DataNodes down: place_keys {t['place_keys']:.4f} ms in "
              f"{sum(launches[engine].values())} launches {launches[engine]}; node_route "
              f"{t['node_route']:.4f} ms, bound {nb['bound_ms']:.4f} ms ({nb['bound_by']}: "
              f"operations {nb['t_ops']:.4f} ms, bytes {nb['t_bytes']:.4f} ms = "
              f"{nb['bytes_per_group']:.1f} B a group), bound/time {share(nb['bound_ms'], t['node_route'])}, "
              f"plain {plain['node_route']:.3f} ms; with old {t['node_route_old']:.4f} ms, bound "
              f"{nb_old:.4f} ms, plain {plain['node_route_old']:.3f} ms; place over the racks "
              f"(family route + resolve's row path) {t['place']:.4f} ms, with old "
              f"{t['place_old']:.4f} ms, bound {pb['bound_ms']:.4f} ms ({pb['bound_by']}), "
              f"bound/time {share(pb['bound_ms'], t['place'])}, plain {plain['place']:.3f} ms; "
              f"max |kernel - plain| {errs}; moved against the healthy layout {moved}; "
              f"{N_TIME / t['place_keys'] / 1e6:.3f} Ggroups/s on {card}")
    return launches


#: the wide placement timed in phase 4 (resolve's row path)
WIDE_R_TIME = 16


#: the route_load timings' fleets (n, capacity, failed, seed): phase 4's
#: fleet (the shared-histogram instance) and the global-count one
LOAD_TIME_FLEETS = {"1000/1024 250 failed": (1000, 1024, 250, 2),
                    "40000/65536 10000 failed": (40000, 65536, 10000, 3)}
#: the route_load timings' batches: phase 4's and the reference's gated one
#: (DESIGN.md §15.4 gates instrumented/bare at 2^20 keys)
LOAD_TIME_SIZES = (N_TIME, N_CHECK)


def load_time(fn, size: int) -> float:
    """Device ms per launch of a route or route_load call of ``size`` keys:
    back-to-back launches at 2^24 keys; at smaller sizes, where a launch is
    shorter than its host enqueue, launches queued behind a sleeping kernel."""
    if size >= N_TIME:
        return time_ms(fn)
    # a host stall during the enqueue voids a reading; take it again
    for _ in range(3):
        ms, held = small_call_ms(fn)
        if held:
            return ms
    fail(f"route_load timing at {size} keys: the launches outlasted the sleep three times")


def load_bound(engine, keys, fleet, shift: int) -> dict:
    """route_load's bound: route's plus the count's own work, per counted key
    its index test and its add (a block histogram's flush or reduction is a
    design's, not the function's); bytes: the accumulator read and written
    once beside route's keys and ids."""
    route_b = bound(engine, "route", keys, fleet)
    counted = (keys.numel() + (1 << shift) - 1) >> shift
    t_ops = route_b["t_ops"] + 2 * counted / hw.LANE_INSTR_S * 1e3
    t_bytes = route_b["t_bytes"] + 8 * fleet.table.numel() / hw.HBM_BW * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                counted=counted, route=route_b)


def phase_route_load_times(rows: dict, card: str) -> None:
    """``route_load`` against ``route`` in turns (route, route_load,
    route_load, route) on each fleet of ``LOAD_TIME_FLEETS`` at each size of
    ``LOAD_TIME_SIZES`` and shifts 6 (the default above ``exact_cutoff``)
    and 0: instrumented/bare and the fixed cost (route_load - route, us);
    at 2^24 keys also its bound, its plain version and the two-call
    composition ``route`` + ``torch.bincount`` (the library yardstick);
    ``place_keys`` at 2^20 keys, r = ``WIDE_R_TIME``.  Adds the
    ``route_load`` rows: phase 4's fleet at 2^24 keys and shift 6, the other
    cells under ``cells``."""
    from repro_torch.core.bulk import PlacementSpec
    from repro_torch.core.registry import make_bulk
    from repro_torch.kernels import ops
    from repro_torch.serving.batch_router import BatchRouter

    keys = u32_tensor(np.random.default_rng(2), N_TIME).cuda()
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        cells = {}
        for label, (n, cap, n_fail, seed) in LOAD_TIME_FLEETS.items():
            _, fleet = make_fleet(engine, n, cap, n_fail, seed)
            args = (fleet.packed, fleet.table, fleet.state)
            counts = torch.zeros(cap, dtype=torch.int32, device="cuda")
            for size in LOAD_TIME_SIZES:
                k = keys[:size]
                for shift in (6, 0):
                    readings = {"route": [], "route_load": []}
                    for which in ("route", "route_load", "route_load", "route"):
                        fn = ((lambda: kernels.route(k, *args)) if which == "route" else
                              (lambda: kernels.route_load(k, *args, counts, 16, shift)))
                        readings[which].append(load_time(fn, size))
                    ms, bare = (statistics.median(readings[w]) for w in ("route_load", "route"))
                    cell = dict(ms=ms, route_ms=bare, ratio=ms / bare, fixed_us=(ms - bare) * 1e3)
                    extra = ""
                    if size == N_TIME:
                        b = load_bound(engine, k, fleet, shift)
                        plain_ms = time_ms(lambda: kernels.route_load_plain(k, *args, counts, 16, shift),
                                           1, 3)
                        lib_ms = time_ms(lambda: torch.bincount(
                            kernels.route(k, *args)[:: 1 << shift], minlength=cap), 3, 5)
                        route_b = b["route"]
                        cell.update(plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b["bound_ms"],
                                    bound_by=b["bound_by"], route_bound_ms=route_b["bound_ms"],
                                    route_share=route_b["bound_ms"] / bare)
                        extra = (f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {b['counted']} "
                                 f"counted), bound/time {share(b['bound_ms'], ms)}; route alone "
                                 f"against its own bound {route_b['bound_ms']:.4f} ms "
                                 f"({route_b['bound_by']}): {share(route_b['bound_ms'], bare)}; route + "
                                 f"torch.bincount {lib_ms:.4f} ms; plain version {plain_ms:.3f} ms")
                    cells[f"{cap}_{size}_s{shift}"] = cell
                    print(f"phase 4 route_load[{engine}] {size} keys, shift {shift}, {label} "
                          f"({'shared histogram' if cap <= SHARED_BINS else 'global count'}): {ms:.4f} ms "
                          f"against route {bare:.4f} ms in turns, instrumented/bare {ms / bare:.4f}, "
                          f"fixed cost {(ms - bare) * 1e3:.2f} us (route_load "
                          f"{', '.join(f'{t:.4f}' for t in readings['route_load'])}; route "
                          f"{', '.join(f'{t:.4f}' for t in readings['route'])}){extra}; on {card}")
        main, shift0 = cells[f"1024_{N_TIME}_s6"], cells[f"1024_{N_TIME}_s0"]
        rows[engine, "route_load"] = dict(main, library_call="route kernel + torch.bincount",
                                          shift0=shift0, shift=6, cells=cells)
        router = BatchRouter(1000, engine=engine, capacity=1024)
        for b in np.random.default_rng(2).choice(999, size=250, replace=False):
            router.fail(int(b))
        pspec = PlacementSpec(router=router.spec, r=WIDE_R_TIME)
        wide_keys = keys[:N_CHECK]
        fam_ms = time_ms(lambda: kernels.route_family(wide_keys, WIDE_R_TIME, *(
            router._fleet_dev.packed, router._fleet_dev.table, router._fleet_dev.state)))
        place = time_ms(lambda: ops.route_replicas_bulk(wide_keys, router._fleet_dev, pspec))
        fleet = router._fleet_dev
        base = kernels.route_family(wide_keys, WIDE_R_TIME, fleet.packed, fleet.table, fleet.state)
        resalt = pspec.resolved_max_resalt
        _, healthy = make_fleet(engine, 1000, 1024, 0, 2)
        prev = kernels.resolve(wide_keys, kernels.route_family(
            wide_keys, WIDE_R_TIME, healthy.packed, healthy.table, healthy.state), healthy.table,
            healthy.state, resalt)[0]
        regs = registers(FUNCTIONS[engine, "resolve_rows"])
        cells = {}
        for tag, old in (("", None), ("_old", prev)):
            out = kernels.resolve(wide_keys, base, fleet.table, fleet.state, resalt, old)[0]
            ms = time_ms(lambda old=old: kernels.resolve(wide_keys, base, fleet.table, fleet.state,
                                                         resalt, old))
            plain = time_ms(lambda old=old: kernels.resolve_plain(wide_keys, base, fleet.table,
                                                                  fleet.state, resalt, old), 1, 3)
            rb = resolve_bound(wide_keys, base, out, WIDE_R_TIME, with_old=old is not None)
            per_warp, warps, stride, grid = rows_shape(WIDE_R_TIME, old is not None, N_CHECK)
            cells[f"resolve_rows_r{WIDE_R_TIME}_2^20{tag}"] = dict(
                ms=ms, plain_ms=plain, bound_ms=rb["bound_ms"], bound_by=rb["bound_by"],
                t_ops=rb["t_ops"], t_bytes=rb["t_bytes"], registers=regs,
                keys_a_warp=per_warp, warps_a_block=warps, grid=grid,
                shared_bytes_a_block=4 * stride * per_warp * warps * (2 if old is not None else 1))
            print(f"phase 4 resolve_kernel<false>[{engine}] alone, {N_CHECK} keys x r = {WIDE_R_TIME}, "
                  f"1000/1024 with 250 failed, max_resalt {resalt}"
                  f"{', with old (the migration diff)' if old is not None else ''}: {ms:.4f} ms, bound "
                  f"{rb['bound_ms']:.4f} ms ({rb['bound_by']}; bytes {rb['t_bytes']:.4f} ms, operations "
                  f"{rb['t_ops']:.4f} ms), bound/time {share(rb['bound_ms'], ms)}; {per_warp} keys a "
                  f"warp, {warps} warps a block, a grid of {grid}, "
                  f"{cells[f'resolve_rows_r{WIDE_R_TIME}_2^20{tag}']['shared_bytes_a_block']} B of "
                  f"shared memory a block, {regs} registers, plain version {plain:.3f} ms; on {card}")
        rows[engine, "resolve"].update({
            f"r{WIDE_R_TIME}_place_keys_2^20_ms": place,
            f"r{WIDE_R_TIME}_route_family_2^20_ms": fam_ms, **cells})
        print(f"phase 4 place_keys[{engine}] {N_CHECK} keys, r = {WIDE_R_TIME} (resolve's row path), "
              f"1000/1024 with 250 failed: {place:.4f} ms, of which the family route {fam_ms:.4f} ms; "
              f"on {card}")


#: SASS instructions of chain_remap_kernel (sm_90a, max_chain > 0),
#: counted by hand in ``cuobjdump -sass`` of the build: ``CHAIN_KEY`` per
#: key of a chunk's scan (325 a lane for its 8 keys of a full chunk: the
#: chunk's head and its bucket loads, 48; the 8 keys' mask-word tests,
#: stores and ballots, 265; the chunk's tail, 12), ``CHAIN_REMOVED`` more
#: for a key whose bucket is removed (its ring entry written and its key's
#: cp.async issued, 14; the entry taken at a refill, 25; its answer's
#: store, 6) and ``CHAIN_STEP`` per step of its walk (hash_iter's add and
#: fmix32, the pair mix, the fastmod, the mask-word test, the steps-left
#: test).  The bound counts these, the work.  ``CHAIN_TRIP`` is the
#: refill's bookkeeping a trip of one step (the top-up test, the ballot
#: cursor, the copy wait, the loop): this design's overhead, not the work,
#: so phase 4 adds it only to what this build issues.  The thread's
#: prologue (the state loads, the fastmod magic) is once per thread, not
#: per key, and is left out.
CHAIN_KEY = 325 / 8
CHAIN_REMOVED = 45
CHAIN_STEP = 49
CHAIN_TRIP = 64


def phase_chain_times(rows: dict, card: str) -> None:
    """The storm cliff on the card: the chain-mode two-pass path
    (``lookup_dyn`` + ``chain_remap``) against the table route (``route``,
    one launch) at 2^24 keys, in turns (chain, route, route, chain) x 3, at
    each failed share of ``CHAIN_SHARES`` (1000/1024); ``chain_remap``
    alone, held against its plain version, beside its bound (bytes: 8 B a
    key, and the 32-byte key sectors that hold a removed key, since only
    those keys are read; operations: ``CHAIN_KEY`` per key,
    ``CHAIN_REMOVED`` per removed key and ``CHAIN_STEP`` per step of this
    data's walks, counted by the plain version's own walk), what this build
    issues (the bound's operations and ``CHAIN_TRIP`` a step), its time at
    max_chain 0 (the scan alone) and 1, and the plain version's time.  The
    walk: the mean per key and per removed key; the steps per lane of the
    kernel's resident grid (what its warps issue: each lane walks queued
    keys until the ring runs dry); and, for the first build's one thread
    per key, the mean over warps of 32 consecutive keys of their longest
    walk, and the steps per lane that layout issued (every warp its longest
    walk, over the same resident grid)."""
    from repro_torch.core.bulk import ChainFleet, RouterSpec
    from repro_torch.core.registry import make_bulk
    from repro_torch.kernels import build, ops

    rng = np.random.default_rng(7)
    keys = u32_tensor(rng, N_TIME).cuda()
    grid = build.library().routing_chain_grid(N_TIME)
    lanes = grid * 256
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        spec = RouterSpec(engine, 1024)
        by_share = {}
        for i, frac in enumerate(CHAIN_SHARES):
            n_fail = int(frac * 1000)
            plane = chain_plane(engine, 1000, n_fail, 20 + i)
            _, fleet = make_fleet(engine, 1000, 1024, n_fail, 20 + i)  # the same failed slots
            chain = ChainFleet.pack(plane.domain, 1024).to("cuda")
            if not torch.equal(chain.packed, fleet.packed):
                fail("the chain and table fleets of the storm sweep differ")
            base = kernels.lookup_dyn(keys, chain.state[:1])
            cases = {
                "chain": lambda: ops.route_chain_bulk(keys, chain, spec),
                "route": lambda: kernels.route(keys, fleet.packed, fleet.table, fleet.state),
            }
            readings = {w: [] for w in cases}
            for _ in range(3):
                for which in ("chain", "route", "route", "chain"):
                    readings[which].append(time_ms(cases[which]))
            med = {w: statistics.median(v) for w, v in readings.items()}
            remap_ms = time_ms(lambda: kernels.chain_remap(keys, base, chain.packed, chain.state))
            lookup_ms = time_ms(lambda: kernels.lookup_dyn(keys, chain.state[:1]))
            plain_ms = time_ms(lambda: kernels.chain_remap_plain(keys, base, chain.packed,
                                                                 chain.state), 1, 3)
            want, steps = kernels.chain_remap_plain(keys, base, chain.packed, chain.state,
                                                    return_steps=True)
            if not torch.equal(kernels.chain_remap(keys, base, chain.packed, chain.state), want):
                fail(f"chain_remap[{engine}] at {frac:.0%} failed disagrees with its plain version")
            total_steps = int(steps.sum())
            hit = int((steps > 0).sum())
            warp_max = steps.reshape(-1, 32).max(1).values.double()
            # Bytes this data needs: each bucket read and written (8 B a
            # key), a key read only where its bucket is removed, in whole
            # 32-byte sectors of 8 keys, and the mask words and scalars.
            key_sectors = int((steps.reshape(-1, 8) > 0).any(1).sum())
            t_bytes = (8 * N_TIME + 32 * key_sectors + 4 * (chain.packed.numel() + 2)) \
                / hw.HBM_BW * 1e3
            t_ops = (CHAIN_KEY * N_TIME + CHAIN_REMOVED * hit + CHAIN_STEP * total_steps) \
                / hw.LANE_INSTR_S * 1e3
            t_issued = t_ops + CHAIN_TRIP * total_steps / hw.LANE_INSTR_S * 1e3
            b = dict(bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes")
            # what the walk costs on the card: the scan alone (max_chain 0:
            # removed keys take first_alive, nothing is queued), one step
            by_max = {m: time_ms(lambda m=m: kernels.chain_remap(keys, base, chain.packed,
                                                                  chain.state, m))
                      for m in (0, 1)}
            per_lane = total_steps / lanes
            per_lane_one_thread = float(warp_max.sum()) * 32 / lanes
            by_share[f"{frac:.0%}"] = dict(
                ms=remap_ms, plain_ms=plain_ms, two_pass_ms=med["chain"], route_ms=med["route"],
                lookup_dyn_ms=lookup_ms, key_sector_share=key_sectors * 8 / N_TIME,
                mean_steps=total_steps / N_TIME,
                mean_steps_removed=total_steps / max(hit, 1), removed_share=hit / N_TIME,
                steps_per_lane=per_lane, steps_per_lane_one_thread_per_key=per_lane_one_thread,
                warp_max_mean=float(warp_max.mean()), warp_max_max=int(warp_max.max()),
                t_ops_ms=t_ops, t_bytes_ms=t_bytes, issued_ms=t_issued,
                max_chain0_ms=by_max[0], max_chain1_ms=by_max[1], **b)
            print(f"phase 4 chain[{engine}] {N_TIME} keys, 1000/1024 with {n_fail} failed "
                  f"({frac:.0%}): two-pass chain (lookup_dyn + chain_remap) {med['chain']:.4f} ms "
                  f"against route (table) {med['route']:.4f} ms in turns, chain/route "
                  f"{med['chain'] / med['route']:.3f} (chain "
                  f"{', '.join(f'{t:.4f}' for t in readings['chain'])}; route "
                  f"{', '.join(f'{t:.4f}' for t in readings['route'])}); chain_remap alone "
                  f"{remap_ms:.4f} ms, lookup_dyn alone {lookup_ms:.4f} ms; walk: "
                  f"{hit / N_TIME:.2%} of keys removed, mean {total_steps / N_TIME:.4f} steps per "
                  f"key ({total_steps / max(hit, 1):.3f} per removed key), {per_lane:.2f} steps "
                  f"per lane of the resident grid ({grid} blocks of 256); one thread per key "
                  f"would issue {per_lane_one_thread:.2f} per lane (per warp of 32 keys the "
                  f"longest walk {float(warp_max.mean()):.3f} on average, at most "
                  f"{int(warp_max.max())}); bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
                  f"instructions {t_ops:.4f} ms, bytes {t_bytes:.4f} ms with "
                  f"{key_sectors * 8 / N_TIME:.2%} of the key sectors read), bound/time "
                  f"{share(b['bound_ms'], remap_ms)}; this build issues {t_issued:.4f} ms "
                  f"with the refill's bookkeeping; chain_remap at max_chain 0 (the scan "
                  f"alone) {by_max[0]:.4f} ms, at max_chain 1 {by_max[1]:.4f} ms; plain "
                  f"version {plain_ms:.3f} ms; on {card}")
        base0 = by_share["0%"]
        for key, row in by_share.items():
            row.update(chain_storm_over_steady=row["two_pass_ms"] / base0["two_pass_ms"],
                       route_storm_over_steady=row["route_ms"] / base0["route_ms"])
        print(f"phase 4 storm cliff[{engine}]: two-pass chain at "
              + ", ".join(f"{k} {v['chain_storm_over_steady']:.3f}x" for k, v in by_share.items())
              + " of its healthy time; route (table) at "
              + ", ".join(f"{k} {v['route_storm_over_steady']:.3f}x" for k, v in by_share.items())
              + f"; on {card}")
        head = by_share["25%"]
        rows[engine, "chain_remap"] = dict(
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], failed_share=0.25, by_share=by_share)


def train_baseline(src_dir: Path, card: str, rounds: int = 3) -> None:
    """Another build of the training kernels (``src_dir/train.cu``, the same
    C interface) against this one on the select, in turns (baseline, this,
    this, baseline) for ``rounds`` rounds, medians: each round's
    ``radix_hist`` launch and the whole select on a gradient-like leaf of
    experts_wi's size at the train path's k, both builds' thresholds equal
    to ``torch.topk``'s."""
    import hashlib

    from repro_torch.kernels import build
    from repro_torch.kernels import train as T

    name = src_dir.resolve().name
    digest = hashlib.sha256((src_dir / "train.cu").read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"baseline_train_{digest}.so"
    if not out.is_file():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                               str(src_dir / "train.cu")], capture_output=True, text=True)
        if proc.returncode:
            fail(f"the baseline build of {src_dir}/train.cu failed:\n{proc.stdout}{proc.stderr}")
    libs = {"baseline": build._load(out, build.TRAIN_SIGNATURES), "this": build.train_library()}
    loaded = build.train_library
    gen = torch.Generator("cuda").manual_seed(44)
    x = torch.randn(EXPERTS_WI, generator=gen, device="cuda") * 1e-4
    k = int(EXPERTS_WI * TOPK_FRAC)
    want = int(bits_of(torch.topk(x.abs(), k).values[-1]))
    final = int(bits_of(T.radix_select(x, k)))
    times = {w: {r: [] for r in ("select", *range(len(T.RADIX_ROUNDS)))} for w in libs}
    for _ in range(rounds):
        for which in ("baseline", "this", "this", "baseline"):
            build.train_library = lambda lib=libs[which]: lib
            try:
                if int(bits_of(T.radix_select(x, k))) != want:
                    fail(f"the select of the {which} build ({name}) differs from torch.topk's")
                for r, (shift, width) in enumerate(T.RADIX_ROUNDS):
                    top = shift + width
                    prefix = torch.tensor([final & ~((1 << top) - 1) if top < 32 else 0],
                                          dtype=torch.int32, device="cuda")
                    times[which][r].append(time_ms(
                        lambda p=prefix, sh=shift, w=width: T.radix_hist(x, p, sh, w), 3, 3))
                times[which]["select"].append(time_ms(lambda: T.radix_select(x, k), 1, 3))
            finally:
                build.train_library = loaded
    med = {w: {r: statistics.median(v) for r, v in t.items()} for w, t in times.items()}
    print(f"phase 4 baseline {name} train kernels, the select on {EXPERTS_WI:,} gradient-like "
          f"values at k = {k:,}, in turns x{rounds}: " + "; ".join(
              f"{w} radix_hist rounds " + ", ".join(f"{med[w][r]:.4f}" for r in range(3))
              + f" ms, select {med[w]['select']:.4f} ms" for w in ("baseline", "this"))
          + f"; both equal to torch.topk's k-th value, on {card}")
    del x


def baseline_library(src_dir: Path):
    """Another build of the kernels (``src_dir/routing.cu``, the same C
    interface), compiled with this build's flags and loaded."""
    import ctypes
    import hashlib

    from repro_torch.kernels import build

    digest = hashlib.sha256(b"".join((src_dir / f).read_bytes() for f in build.SOURCES))
    out = build.BUILD_DIR / f"baseline_{digest.hexdigest()[:16]}.so"
    if not out.is_file():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                               str(src_dir / "routing.cu")], capture_output=True, text=True)
        if proc.returncode:
            fail(f"the baseline build of {src_dir} failed:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    print(f"phase 4 baseline {src_dir.resolve().name} build ({out.name}); ptxas: " + " | ".join(
        line.strip() for line in out.with_suffix(".log").read_text().splitlines()
        if "registers" in line))
    lib = ctypes.CDLL(str(out))
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    return lib


def in_turns(libs: dict, cases: dict, measure, rounds: int) -> dict:
    """``measure(fn)`` of each case under each library, in turns (baseline,
    this, this, baseline) for ``rounds`` rounds -> {library: [readings]}."""
    from repro_torch.kernels import build

    loaded = build.library
    times = {w: [] for w in libs}
    for _ in range(rounds):
        for which in ("baseline", "this", "this", "baseline"):
            build.library = lambda lib=libs[which]: lib
            try:
                times[which].append(measure(cases[which]))
            finally:
                build.library = loaded
    return times


def baseline_route_load(libs: dict, name: str, engine: str, keys, rows: dict, rounds: int) -> None:
    """``route_load`` of this build against ``name``'s in turns on each cell of
    phase 4's (``LOAD_TIME_FLEETS`` x ``LOAD_TIME_SIZES`` x shifts 6 and 0),
    both builds' replica ids equal (and their counts, where they differ the
    line says so: a design fork may drop a count); then the host time of a
    64-key ``route_keys`` on a monitored ``BatchRouter`` (the streaming
    path's dispatch, counted exactly: shift 0) under each build."""
    from repro_torch.core.registry import make_bulk
    from repro_torch.observability import LoadConfig, LoadMonitor
    from repro_torch.serving.batch_router import BatchRouter

    kernels = make_bulk(engine).kernels
    turns = rows[engine, "route_load"].setdefault("in_turns", {}).setdefault(name, {})
    for label, (n, cap, n_fail, seed) in LOAD_TIME_FLEETS.items():
        _, fleet = make_fleet(engine, n, cap, n_fail, seed)
        args = (fleet.packed, fleet.table, fleet.state)
        counts = torch.zeros(cap, dtype=torch.int32, device="cuda")
        for size in LOAD_TIME_SIZES:
            k = keys[:size]
            for shift in (6, 0):
                def call(k=k, shift=shift):
                    return kernels.route_load(k, *args, counts, 16, shift)

                def fresh(k=k, shift=shift):
                    return kernels.route_load(k, *args, torch.zeros_like(counts), 16, shift)

                outs = in_turns(libs, {"baseline": fresh, "this": fresh}, lambda f: f(), 1)
                (ids_b, counts_b), (ids_t, counts_t) = outs["baseline"][0], outs["this"][0]
                if not torch.equal(ids_b, ids_t):
                    fail(f"route_load[{engine}] of {name} and of this build route differently "
                         f"({label}, {size} keys, shift {shift})")
                times = in_turns(libs, {"baseline": call, "this": call},
                                 lambda f, size=size: load_time(f, size), rounds)
                med = {w: statistics.median(t) for w, t in times.items()}
                turns[f"{cap}_{size}_s{shift}_ms"] = {"baseline": med["baseline"], "this": med["this"]}
                print(f"phase 4 baseline {name} route_load[{engine}] {size} keys, shift {shift}, {label}, "
                      f"in turns x{rounds}: baseline {med['baseline']:.4f} ms, this build "
                      f"{med['this']:.4f} ms ({med['baseline'] / med['this']:.3f}x); counts "
                      f"{'equal' if torch.equal(counts_b, counts_t) else 'DIFFER'}; baseline "
                      f"{', '.join(f'{t:.4f}' for t in times['baseline'])}; this "
                      f"{', '.join(f'{t:.4f}' for t in times['this'])}")
    router = BatchRouter(1000, engine=engine, capacity=1024)
    for b in np.random.default_rng(2).choice(999, size=250, replace=False):
        router.fail(int(b))
    LoadMonitor(router, config=LoadConfig(drain_every=1 << 30))
    batch = keys[:64]
    host = in_turns(libs, {"baseline": lambda: router.route_keys(batch),
                           "this": lambda: router.route_keys(batch)},
                    lambda f: host_ms(f, 2000), rounds)
    med = {w: statistics.median(t) * 1e3 for w, t in host.items()}
    turns["host_us_route_keys_64"] = {"baseline": med["baseline"], "this": med["this"]}
    print(f"phase 4 baseline {name} route_load[{engine}] host per 64-key route_keys on a monitored "
          f"BatchRouter(1000, capacity=1024), in turns x{rounds}: baseline {med['baseline']:.2f} us, "
          f"this build {med['this']:.2f} us ({med['this'] / med['baseline']:.3f}x); baseline "
          f"{', '.join(f'{t * 1e3:.2f}' for t in host['baseline'])}; this "
          f"{', '.join(f'{t * 1e3:.2f}' for t in host['this'])}")


def phase_baseline(src_dir: Path, rows: dict, serve_calls: dict, moe_cfg,
                   rounds: int = 3) -> None:
    """This build against ``src_dir``'s, in turns (baseline, this, this,
    baseline) for ``rounds`` rounds, medians: every instance at 2^24 keys,
    ``chain_remap`` at each failed share of ``CHAIN_SHARES`` (both builds'
    answers equal), ``route_load`` as ``baseline_route_load`` says, and the
    router call at the serve path's sizes, where a baseline without
    ``routing_lookup_router`` builds the keys with torch (``router_keys``)
    before its lookup_vec.  Rows gain ``in_turns[<directory name>]``."""
    from repro_torch.configs import get_config
    from repro_torch.core.binomial_torch import router_keys
    from repro_torch.core.bulk import ChainFleet
    from repro_torch.core.registry import make_bulk
    from repro_torch.kernels import build

    name = src_dir.resolve().name
    libs = {"baseline": baseline_library(src_dir), "this": build.library()}
    fused = hasattr(libs["baseline"], "routing_lookup_router")
    rng = np.random.default_rng(2)
    keys = u32_tensor(rng, N_TIME).cuda()
    hi = u32_tensor(rng, N_TIME).cuda()
    tokens_big = torch.from_numpy(rng.integers(0, get_config(SERVE_ARCH).vocab_size,
                                               size=N_TIME // moe_cfg.top_k)).cuda()
    for engine in ENGINES:
        kernels = make_bulk(engine).kernels
        _, fleet = make_fleet(engine, 1000, 1024, 250, 2)
        cases = {(kind, "ms"): (lambda kind=kind: run_kind(kernels, kind, keys, hi, fleet, plain=False))
                 for kind in KINDS}
        cases["lookup_vec", "n1025_ms"] = lambda: kernels.lookup_vec(keys, VEC_N_HALF)
        if hasattr(libs["baseline"], "routing_route_family"):
            cases["route_family", "ms"] = lambda: kernels.route_family(
                keys, PLACE_R, fleet.packed, fleet.table, fleet.state)
        if hasattr(libs["baseline"], "routing_resolve"):
            # resolve's register path at phase 4's r = 3, and its row path at
            # 2^20 keys x r = 16 with and without old; both builds' answers equal
            args = (fleet.packed, fleet.table, fleet.state)
            base3 = kernels.route_family(keys, PLACE_R, *args)
            wide = keys[:N_CHECK]
            base16 = kernels.route_family(wide, WIDE_R_TIME, *args)
            _, healthy = make_fleet(engine, 1000, 1024, 0, 2)
            old16 = kernels.resolve(wide, kernels.route_family(
                wide, WIDE_R_TIME, healthy.packed, healthy.table, healthy.state), healthy.table,
                healthy.state, WIDE_R_TIME)[0]
            resolves = {
                "ms": lambda: kernels.resolve(keys, base3, fleet.table, fleet.state, PLACE_R),
                f"rows_r{WIDE_R_TIME}_2^20_ms": lambda: kernels.resolve(
                    wide, base16, fleet.table, fleet.state, WIDE_R_TIME),
                f"rows_r{WIDE_R_TIME}_2^20_old_ms": lambda: kernels.resolve(
                    wide, base16, fleet.table, fleet.state, WIDE_R_TIME, old16),
            }
            for field, fn in resolves.items():
                outs = in_turns(libs, {"baseline": fn, "this": fn}, lambda f: f(), 1)
                if not all(torch.equal(a, b) for a, b in zip(outs["baseline"][0], outs["this"][0])
                           if a is not None):
                    fail(f"resolve[{engine}] ({field}) of {name} and of this build differ")
                cases["resolve", field] = fn
        if fused:
            cases["lookup_router", "ms"] = lambda: kernels.lookup_router(
                tokens_big, 3, moe_cfg.top_k, moe_cfg.num_experts, moe_cfg.router_hash_omega)
        if hasattr(libs["baseline"], "routing_chain_remap"):
            # the storm sweep's chain fleets: 2^24 keys at each failed share
            for i, frac in enumerate(CHAIN_SHARES):
                plane = chain_plane(engine, 1000, int(frac * 1000), 20 + i)
                chain = ChainFleet.pack(plane.domain, 1024).to("cuda")
                base = kernels.lookup_dyn(keys, chain.state[:1])
                fn = (lambda chain=chain, base=base:
                      kernels.chain_remap(keys, base, chain.packed, chain.state))
                outs = in_turns(libs, {"baseline": fn, "this": fn}, lambda f: f(), 1)
                if not torch.equal(outs["baseline"][0], outs["this"][0]):
                    fail(f"chain_remap[{engine}] of {name} and of this build differ at "
                         f"{frac:.0%} failed")
                cases["chain_remap", f"{frac:.0%}_ms"] = fn
        for (kind, field), fn in cases.items():
            times = in_turns(libs, {"baseline": fn, "this": fn}, time_ms, rounds)
            med = {w: statistics.median(t) for w, t in times.items()}
            turns = rows[engine, kind].setdefault("in_turns", {}).setdefault(name, {})
            turns[field] = {"baseline": med["baseline"], "this": med["this"]}
            label = kind + (f" n={VEC_N_HALF}" if field == "n1025_ms" else "") + (
                f" {field[:-3]} failed" if kind == "chain_remap" else "") + (
                f" {field[:-3]}" if kind == "resolve" and field != "ms" else "")
            print(f"phase 4 baseline {name} {label}[{engine}] "
                  f"{N_CHECK if '2^20' in field else N_TIME} keys, in turns x{rounds}: "
                  f"baseline {med['baseline']:.4f} ms, this build {med['this']:.4f} ms "
                  f"({med['baseline'] / med['this']:.3f}x); baseline "
                  f"{', '.join(f'{t:.4f}' for t in times['baseline'])}; this "
                  f"{', '.join(f'{t:.4f}' for t in times['this'])}")
        if hasattr(libs["baseline"], "routing_route_load"):
            baseline_route_load(libs, name, engine, keys, rows, rounds)
        for phase, by_engine in serve_calls.items():
            tokens, salt = by_engine[engine]
            k, n, omega = moe_cfg.top_k, moe_cfg.num_experts, moe_cfg.router_hash_omega
            this = lambda: kernels.lookup_router(tokens, salt, k, n, omega)  # noqa: E731
            cases = {"this": this, "baseline": this if fused else lambda: kernels.lookup_vec(
                router_keys(tokens, salt, k).to(torch.int32), n, omega)}
            # 20 calls: a torch key build's ~20 launches per call must all queue
            dev = in_turns(libs, cases, lambda fn: small_call_ms(fn, 20), rounds)
            host = in_turns(libs, cases, lambda fn: host_ms(fn, 200), rounds)
            med = {w: statistics.median(t for t, _ in v) for w, v in dev.items()}
            held = all(h for v in dev.values() for _, h in v)
            hmed = {w: statistics.median(v) for w, v in host.items()}
            turns = rows[engine, "lookup_router"].setdefault("in_turns", {}).setdefault(name, {})
            turns[f"{phase}_ms"] = {"baseline": med["baseline"], "this": med["this"]}
            turns[f"{phase}_host_ms"] = {"baseline": hmed["baseline"], "this": hmed["this"]}
            how = "lookup_router" if fused else "torch key build + lookup_vec"
            print(f"phase 4 baseline {name} router call[{engine}] at the serve path's {phase} size "
                  f"{tuple(tokens.shape)}, in turns x{rounds}: device per call baseline ({how}) "
                  f"{med['baseline'] * 1e3:.2f} us, this build (lookup_router) "
                  f"{med['this'] * 1e3:.2f} us{'' if held else ' (NOT all enqueued within the sleep)'}; "
                  f"host per call baseline {hmed['baseline'] * 1e3:.2f} us, this "
                  f"{hmed['this'] * 1e3:.2f} us")


def train_kernel_rows(by_path: dict, max_err: dict, adamw_row: dict, compress: dict) -> list:
    """The kernels line's rows of the training kernels: their launches on
    the main paths (both engines' runs summed), phase 2's differing
    elements, and the times phases 3 "train" (``adamw_update`` on the
    largest leaf) and "compress" (the select on the largest leaf, binomial
    engine's run) measured; ``radix_hist``'s time is a launch's mean over
    the three rounds, ``radix_pick``'s one launch, and the whole select's
    numbers ride along."""
    select = compress["binomial", "select"]
    hist_ms = statistics.mean(select["hist_ms"])
    n = select["elements"]
    rows = {
        "adamw_update": {k: adamw_row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by", "elements")},
        "radix_hist": dict(ms=hist_ms, plain_ms=statistics.mean(select["hist_plain_ms"]),
                           library_ms=None, bound_ms=select["bound_ms"], bound_by="bytes",
                           elements=n, round_ms=select["hist_ms"],
                           round_plain_ms=select["hist_plain_ms"], select_ms=select["ms"],
                           select_topk_ms=select["topk_ms"], select_plain_ms=select["plain_ms"],
                           select_bound_ms=select["bound_ms"],
                           select_design_bound_ms=3 * select["bound_ms"],
                           step_select_ms=select["step_select_ms"]),
        # the pick reads a 2^11-bin int64 histogram and writes two words
        "radix_pick": dict(ms=select["pick_ms"], plain_ms=select["pick_plain_ms"], library_ms=None,
                           bound_ms=(8 * 2048 + 24) / hw.HBM_BW * 1e3, bound_by="bytes"),
    }
    rows["adamw_update"]["in_step"] = adamw_row["in_step"]
    out = []
    for kind in TRAIN_KINDS:
        paths = {}
        for path, counts in by_path.items():
            got = sum(counts.get((e, kind), 0) for e in ENGINES)
            if got:
                paths[path] = got
        out.append(dict(name=kind, route="cuda", source=TRAIN_SRC, replaces=TRAIN_REPLACES[kind],
                        launches=sum(paths.values()), launches_by_path=paths,
                        max_abs_err=max_err[kind], bit_exact=max_err[kind] == 0, **rows[kind]))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, nargs="+", default=[],
                        help="directories each holding another build's routing.cu/.cuh or "
                             "train.cu to time against")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.analysis import sass_gate
    from repro_torch.kernels import build

    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:  # one nvcc per output, started together
        futures = [pool.submit(f) for f in (build.build, build.ptx, build.cubin, build.counting,
                                            build.build_train)]
        lib, ptx, _, counting, train_lib = (f.result() for f in futures)

    def ptxas_lines(path):
        return " | ".join(line.strip() for line in path.with_suffix(".log").read_text().splitlines()
                          if "registers" in line)

    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({lib.name}); ptxas: {ptxas_lines(lib)}")
    print(f"phase 1 counting build ({counting.name}, -DROUTING_COUNT_TRIPS): ptxas: "
          f"{ptxas_lines(counting)}")
    print(f"phase 1 training kernels' build ({train_lib.name}): ptxas: {ptxas_lines(train_lib)}")
    text = ptx.read_text()
    if "div.rn.f32" not in text or "div.approx" in text or "div.full" in text:
        fail("the jump step is not compiled to an IEEE round-to-nearest division")
    print(f"phase 1 ptx: div.rn.f32 x{text.count('div.rn.f32')}, no approximate division")
    sizes = {name: fn.size for name, fn in sass_gate.library_sass().items()}
    found = {key: [n for name, n in sizes.items() if name.startswith(prefix)]
             for key, prefix in FUNCTIONS.items()}
    print("phase 1 sass instructions " + json.dumps(
        {f"{k}[{e}]": n for (e, k), n in found.items()}))
    stale = [f"{k}[{e}]" for (e, k), n in found.items() if n != [SASS_STATIC[e, k]]]
    if stale:
        fail(f"the SASS of {stale} differs from the build the SASS table was counted "
             "from: recount the table")
    build.library()
    build.train_library()
    phase_certify(card)

    max_err: dict = {}
    phase_kernels(max_err)
    phase_tails(max_err)
    phase_lookup_router(max_err)
    phase_placement_kernels(max_err)
    phase_placement_wide(max_err)
    phase_rows_edges(max_err)
    phase_route_load(max_err)
    phase_chain_remap(max_err)
    phase_train_kernels(max_err)
    by_path = {"router": phase_router(), "chain": phase_chain_path()}
    mesh_launches, mesh = phase_mesh(card)
    by_path["mesh"] = {(e, k): n for e, counts in mesh_launches.items() for k, n in counts.items()}
    serve_launches, serve_calls, mesh_serve_launches = phase_serve(card, mesh)
    import torch.distributed as dist

    dist.destroy_process_group()
    by_path["serve"] = {(e, k): n for e, counts in serve_launches.items() for k, n in counts.items()}
    by_path["mesh_serve"] = {(e, k): n for e, counts in mesh_serve_launches.items()
                             for k, n in counts.items()}
    dsv3_launches = phase_serve_dsv3(card)
    by_path["serve_dsv3"] = {(e, k): n for e, counts in dsv3_launches.items()
                             for k, n in counts.items()}
    for arch, counts in phase_serve_families(card).items():
        by_path[f"serve_{arch}"] = {(e, k): n for e, c in counts.items() for k, n in c.items()}
    train_launches, adamw_row = phase_train(card)
    by_path["train"] = {(e, k): n for e, counts in train_launches.items()
                        for k, n in counts.items()}
    by_path["mesh_train"] = {(e, k): n for e, counts in phase_mesh_train(card).items()
                             for k, n in counts.items()}
    compress_launches, compress_numbers = phase_compress(card)
    by_path["compress"] = {(e, k): n for e, counts in compress_launches.items()
                           for k, n in counts.items()}
    place_launches, place_host = phase_placement()
    by_path["placement"] = {(e, k): n for e, counts in place_launches.items() for k, n in counts.items()}
    stream_launches, stream_numbers = phase_streaming()
    by_path["streaming"] = {(e, k): n for e, counts in stream_launches.items() for k, n in counts.items()}
    by_path["examples"] = {(e, k): n for e, counts in phase_examples(card).items()
                           for k, n in counts.items()}
    from repro_torch.configs import get_config

    moe_cfg = get_config(SERVE_ARCH).moe
    rows = phase_times(serve_calls, moe_cfg)
    phase_placement_times(rows, card)
    phase_route_load_times(rows, card)
    phase_chain_times(rows, card)
    by_path["racks"] = {(e, k): n for e, counts in phase_racks(rows, max_err, card).items()
                        for k, n in counts.items()}
    for engine, numbers in stream_numbers.items():
        rows[engine, "route_load"]["streaming"] = {
            k: v for k, v in numbers.items() if isinstance(v, (int, float))}
    for engine, numbers in place_host.items():
        rows[engine, "route_family"].update(
            {f"store_2^20_{k}": v for k, v in numbers.items()
             if k in ("sync_targets_s", "quiesce_s", "storm_copies", "storm_tick_s", "moved_fraction",
                      "delta_over_n", "lost_keys")})
    for src_dir in args.baseline:
        if (src_dir / "routing.cu").is_file():
            phase_baseline(src_dir, rows, serve_calls, moe_cfg)
        if (src_dir / "train.cu").is_file():
            train_baseline(src_dir, card)
    kernels = []
    for engine in ENGINES:
        for kind in ROWS:
            paths = {p: c[engine, kind] for p, c in by_path.items() if (engine, kind) in c}
            kernels.append(dict(
                name=f"{kind}[{engine}]", route="cuda", source=SRC, replaces=REPLACES[kind],
                launches=sum(paths.values()), launches_by_path=paths,
                max_abs_err=max_err[engine, kind], bit_exact=max_err[engine, kind] == 0,
                **{"library_ms": None, **rows[engine, kind]}))
    kernels.extend(train_kernel_rows(by_path, max_err, adamw_row, compress_numbers))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
