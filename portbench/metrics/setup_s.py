"""Seconds from the start of the process to the window: imports, the CUDA
context, the kernels' build or load, the fleet, the key pool on the device,
registration where the cell registers objects, and the warm-up."""


def read(run):
    return run.setup_s
