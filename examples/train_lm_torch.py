"""Example on the PyTorch port: train a small LM for a few steps with the
full substrate (CH-sharded data, checkpoint/auto-resume, cosine schedule).

    PYTHONPATH=src python examples/train_lm_torch.py              # the CUDA card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --preset 100m

A thin veneer over the port's training launcher (``repro_torch.launch.train``)
with ``examples/train_lm.py``'s default arguments, so the example runs the
deployed code path.  Its checkpoint goes to a temporary directory of its
own, removed when the run ends, unless ``--ckpt-dir`` names one (rerun
with that directory to resume).
"""
import argparse
import sys
import tempfile

from repro_torch.device import describe, resolve_device
from repro_torch.launch.train import main as train

DEFAULTS = ["--arch", "qwen2.5-14b", "--preset", "smoke", "--steps", "30", "--batch", "8",
            "--seq", "64"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], add_help=False)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    print(describe(device))
    rest = rest or DEFAULTS
    if "--ckpt-dir" in rest:
        train([*rest, "--device", str(device)])
        return
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_") as ckpt_dir:
        train([*rest, "--ckpt-dir", ckpt_dir, "--device", str(device)])


if __name__ == "__main__":
    main()
