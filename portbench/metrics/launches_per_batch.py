"""Kernel launches a batch call makes, from the port's launch counters
(``RoutingKernels.launches``), over the traced run's measured window."""


def read(run):
    w = run.window
    return w.call_launches / w.batches if w.batches and len(w.call_s) else None
