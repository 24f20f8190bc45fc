"""Training on one device — the counterpart of ``repro.training``: the
optimizers and their schedule, gradient compression, the train step and
the checkpoint manager with consistent-hash placement of its leaves."""
