"""Share of the program-span stretch's profiled phase in which no kernel,
copy or fill ran on the card while the host was inside one of the port's
own stages (``portbench/harness/spans.py``): the part of
``device_idle_pct`` that the program's host path holds.  It also reads
``idle_in_program_pct.replan``."""
from portbench.harness import spans


def read(run):
    found = spans.of(run)
    return found.idle_in_program_pct if found else None
