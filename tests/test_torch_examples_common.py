"""Helpers of the example tests (``test_torch_examples*.py``): run a port
example with ``--device cpu`` beside its JAX counterpart, both at once in
subprocesses, and compare what they print (``examples/example_output.py``'s
``normalize``)."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))
from example_output import normalize  # noqa: E402,F401  (shared with chip_smoke.py)

#: the seven examples of the JAX package, each with a ``<name>_torch.py``
NAMES = ("quickstart", "serve_lm", "train_lm", "elastic_cluster", "placement_demo",
         "observability_demo", "streaming_demo")


def run_pair(name: str, port_args=(), ref_args=(), timeout: float = 150) -> tuple:
    """``(port stdout, reference stdout)`` of ``examples/<name>_torch.py
    --device cpu`` and ``examples/<name>.py``, run side by side
    (``PYTHONHASHSEED=0`` for both: the quickstart's keys are ``hash()``
    values); fails on a non-zero exit."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTHONHASHSEED": "0",
           "JAX_PLATFORMS": "cpu"}
    cmds = ([sys.executable, str(EXAMPLES / f"{name}_torch.py"), *port_args, "--device", "cpu"],
            [sys.executable, str(EXAMPLES / f"{name}.py"), *ref_args])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for c in cmds]
    outs = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{err}"
        outs.append(out)
    return tuple(outs)
