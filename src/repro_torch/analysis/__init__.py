"""Constant-time certifier of the port — machine-checks the paper's O(1)
guarantee for every registered device engine (DESIGN.md §11), the
counterpart of the JAX package's ``repro.analysis``.

Three layers, one CLI (``python -m repro_torch.analysis``):

* **graph certifier** (``repro_torch.analysis.certify``) — runs every
  ``BULK_ENGINES`` entry's route / ingest / dynamic-n lookup (the plain
  versions, and on the card the kernel wrappers) and the serving,
  lifecycle, placement, streaming and load-monitor paths under a
  ``TorchDispatchMode`` that records their aten ops, enforcing: no item
  read or data-sized output (waivable for paper-faithful baselines via
  ``repro_torch.analysis.markers.constant_time_waiver``), an op count
  affine in the ω unroll bound (flat on the card, where ω is a launch
  argument), dtypes closed over the int64-carried u32 set, no host copy,
  escape or synchronising call, and the declared number of device
  transfers.
* **AST lint** (``repro_torch.analysis.lint``) — source checks over
  ``src/repro_torch/{core,kernels,serving}``: host-sync calls in hot-path
  functions and synchronising CUDA runtime calls in the C entry points,
  literals too wide for the int64 carrier, and global framework config
  mutation.
* **SASS gate** (``repro_torch.analysis.sass_gate``) — on the card, reads
  the compiled kernels: every back edge maps to a loop the source tags
  with its bound (``// ct-loop: <bound>``), healthy and storm fleets run
  the same ops, launches and grids, and each function's SASS stays within
  its budget.

The package ``__init__`` stays import-light (PEP 562 lazy exports) so
``repro_torch.core`` modules can import ``repro_torch.analysis.markers``
without pulling the engine registry in.
"""
from __future__ import annotations

_EXPORTS = {
    "certify_all": "repro_torch.analysis.certify",
    "certify_engine": "repro_torch.analysis.certify",
    "certify_callable": "repro_torch.analysis.certify",
    "record": "repro_torch.analysis.certify",
    "EngineContract": "repro_torch.analysis.certify",
    "lint_paths": "repro_torch.analysis.lint",
    "lint_source": "repro_torch.analysis.lint",
    "gate_all": "repro_torch.analysis.sass_gate",
    "gate_engine": "repro_torch.analysis.sass_gate",
    "constant_time_waiver": "repro_torch.analysis.markers",
    "waivers_of": "repro_torch.analysis.markers",
    "Report": "repro_torch.analysis.report",
    "CheckResult": "repro_torch.analysis.report",
    "TargetReport": "repro_torch.analysis.report",
    "LintFinding": "repro_torch.analysis.report",
    "HloGateResult": "repro_torch.analysis.report",
    "SassGateResult": "repro_torch.analysis.report",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute '{name}'")


def __dir__():
    return sorted(set(globals()) | set(__all__))
