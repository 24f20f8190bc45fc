"""Example on the PyTorch port: serve batched requests across replicas with
BinomialHash session routing, then kill a replica and watch only its
sessions move.

    PYTHONPATH=src python examples/serve_lm_torch.py              # the CUDA card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

A thin veneer over the port's serving launcher (``repro_torch.launch.serve``)
with ``examples/serve_lm.py``'s default arguments; any other arguments go
to the launcher as they are.
"""
import argparse
import sys

from repro_torch.device import describe, resolve_device
from repro_torch.launch.serve import main as serve

DEFAULTS = ["--arch", "stablelm-3b", "--replicas", "3", "--requests", "18", "--fail-replica", "1"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], add_help=False)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    print(describe(device))
    serve([*(rest or DEFAULTS), "--device", str(device)])


if __name__ == "__main__":
    main()
