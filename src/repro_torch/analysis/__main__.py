"""CLI for the constant-time certifier: ``python -m repro_torch.analysis``.

Runs the three layers (graph certifier, AST lint, SASS gate) and exits
nonzero on any unwaived failure:

    PYTHONPATH=src python -m repro_torch.analysis --all-engines
    PYTHONPATH=src python -m repro_torch.analysis --all-engines --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --engine binomial --skip-sass
    PYTHONPATH=src python -m repro_torch.analysis --all-engines --report ct-report/ct.json

It runs for the CUDA card unless ``--device cpu`` asks for the CPU, and
raises without CUDA otherwise.  On the CPU the ``/cuda`` targets and the
SASS checks are reported ``skipped`` with the reason; on the card nothing
is skipped.
"""
from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="machine-check the O(1) contract of every fused engine",
    )
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument(
        "--all-engines",
        action="store_true",
        help="certify every registered BULK_ENGINES entry",
    )
    group.add_argument(
        "--engine",
        action="append",
        metavar="NAME",
        help="certify only this engine (repeatable)",
    )
    parser.add_argument(
        "--skip-lint", action="store_true", help="skip the AST lint layer"
    )
    parser.add_argument(
        "--skip-sass",
        action="store_true",
        help="skip the SASS gate layer (the only layer that compiles)",
    )
    parser.add_argument(
        "--no-chain-baseline",
        action="store_true",
        help="skip the chain-mode memento_remap waiver demonstration target "
             "(and the chain remap kernel in the SASS gate)",
    )
    parser.add_argument(
        "--report",
        metavar="PATH",
        help="write the structured JSON report here",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="print the JSON report to stdout instead of the summary table",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="where the targets run: cuda (the default; raises without CUDA) or cpu",
    )
    args = parser.parse_args(argv)

    from repro_torch.analysis.certify import certify_all
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.analysis.sass_gate import gate_all
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    engines = None if args.all_engines else args.engine
    report = certify_all(
        engines, include_chain_baseline=not args.no_chain_baseline, device=device
    )
    if not args.skip_lint:
        report.lint = lint_paths()
    if not args.skip_sass:
        report.sass = gate_all(engines, device, include_chain=not args.no_chain_baseline)

    if args.report:
        path = pathlib.Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(report.to_json() + "\n")
    print(report.to_json() if args.json else report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
