#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``src/repro_torch``).  Prints the numbers compared for
``correct`` beside their limits as the last lines of standard error, and
one JSON object as the last line of standard output: the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics.  Exits non-zero and
prints no result without a CUDA card (or fewer cards than the cell asks
for), without the port, or when the process holds JAX or the JAX package
once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "nvidia-smi gave no reading"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or torch may keep lies in the checkout, at a
    # fixed path, so that only a checkout's first run builds
    cache = ROOT / ".portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench.harness.registry import Bench

    bench = Bench(ROOT)
    chips = bench.chips(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch
    except ImportError as err:
        print(f"portbench: the port is not in this checkout ({err})", file=sys.stderr)
        return 2
    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        print(f"portbench: repro_torch was imported from {repro_torch.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)

    from portbench.harness import cell

    result, checks = cell.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    found = cell.banned_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for c in checks:
        print(("ok   " if c.ok else "FAIL ") + c.line(), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
