"""What the port's examples (``*_torch.py``) print, put in a form that two
runs can be compared by: the port's example on the card against its CPU
run, or against the JAX package's example.

    from example_output import normalize
    assert normalize(card_stdout) == normalize(cpu_stdout)

Masked: wall times and tokens/s; the numbers that follow the random
weights (losses, gradient norms), which each package and each device draws
differently; the device a launcher names; the checkpoint directory; numpy
2's scalar repr inside a printed list. The port's ``[device]`` line is left
out, and each quickstart's kernel line (the Pallas kernel in interpret
mode, or the CUDA kernel) is masked whole: what it claims is checked
apart."""
import re

#: each pattern with its replacement
MASKS = (
    (re.compile(r"\bnp\.\w+\(([^()]*)\)"), r"\1"),    # numpy 2's scalar repr in a list
    (re.compile(r"\bin \d+(\.\d+)?s\b"), "in <s>s"),  # wall times
    (re.compile(r"\btok/s=[\d,.]+"), "tok/s=<t>"),
    (re.compile(r"\bloss=[-\d.naif]+"), "loss=<w>"),   # weight-dependent
    (re.compile(r"\bgnorm=[-\d.naif]+"), "gnorm=<w>"),
    (re.compile(r" device=\S+"), ""),                  # the port's launchers name it
    (re.compile(r" \((cpu|cuda(:\d+)?)\)"), ""),
    (re.compile(r"\bcheckpoint at \S+"), "checkpoint at <dir>"),
)
#: the line each quickstart prints about its kernel
KERNEL_LINE = re.compile(r"^(pallas|cuda) kernel\s*:")


def normalize(text: str) -> list:
    """The printed lines with ``MASKS`` applied, the ``[device]`` line left
    out and the kernel line masked."""
    out = []
    for line in text.splitlines():
        if line.startswith("[device] "):
            continue
        if KERNEL_LINE.match(line):
            out.append("<kernel line>")
            continue
        for pattern, repl in MASKS:
            line = pattern.sub(repl, line)
        out.append(line)
    return out
