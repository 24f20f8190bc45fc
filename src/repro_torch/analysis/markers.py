"""Allowlist markers for a constant-time certifier (DESIGN.md §11) — a
copy of the JAX package's ``repro.analysis.markers``.

A certifier's invariants are deliberately strict — e.g. ``while-free``
rejects EVERY data-dependent loop it finds, because a data-dependent trip
count is exactly the bug class that produced the 2.57x event-storm cliff
the replacement table removed.  Some callables are *supposed* to carry one
anyway: the paper-faithful chain-mode Memento baseline keeps its bounded
rejection walk as the documented reference semantics.  Those carry an
explicit, reasoned waiver::

    @constant_time_waiver("paper-faithful chain baseline; trip count is "
                          "bounded by the max_chain operand")
    def memento_remap(...):
        ...

A waiver downgrades a *specific* invariant's failure to ``waived`` — it
never hides the finding (a report records the reason), and it never
transfers: every new engine or callable starts unwaived.

This module is import-light on purpose (stdlib only): ``repro_torch.core``
modules mark their baselines without pulling anything else into their
import graph.
"""
from __future__ import annotations

from typing import Any, Callable

#: attribute carrying the marker payload on the marked callable
_ATTR = "__ct_waivers__"


def constant_time_waiver(
    reason: str, *, invariant: str = "while-free"
) -> Callable[[Callable], Callable]:
    """Decorator: allowlist one certifier invariant on one callable.

    ``reason`` is mandatory and lands verbatim in the certification report;
    ``invariant`` names the check being waived (default ``while-free`` —
    the data-dependent-control-flow check).  Apply it on the bare callable or under a
    wrapper that sets ``__wrapped__`` (``waivers_of`` follows the chain).
    """
    if not reason or not reason.strip():
        raise ValueError("a constant_time_waiver requires a non-empty reason")

    def mark(fn: Callable) -> Callable:
        waivers = dict(getattr(fn, _ATTR, {}))
        waivers[invariant] = reason
        setattr(fn, _ATTR, waivers)
        return fn

    return mark


def waivers_of(fn: Any) -> dict[str, str]:
    """Collect waivers from a callable, following ``__wrapped__`` chains
    (so markers applied under ``functools.wraps`` are seen).
    Inner (closer to the marked def) entries win over outer ones only when
    the outer layer did not re-declare the invariant."""
    out: dict[str, str] = {}
    seen: set[int] = set()
    while fn is not None and id(fn) not in seen:
        seen.add(id(fn))
        for invariant, reason in getattr(fn, _ATTR, {}).items():
            out.setdefault(invariant, reason)
        fn = getattr(fn, "__wrapped__", None)
    return out
