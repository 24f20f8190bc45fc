"""The port's host control plane against the JAX package's: the default
failure resolution of ``MementoWrapper`` / ``FailureDomain`` /
``SessionRouter`` (the reference's ``resolve="chain"``, ``chain_bits=64``,
``allow_empty=False``), the chain mode at ``chain_bits`` 32 and 64 over
fail / recover / scale sequences and ``max_chain`` 0, 1, 2 and 4096, every
``ENGINES`` entry over n in 1..300 and through add / remove sequences, and
the closed-form balance theory (``core.analysis``) within 1e-12 relative.
Integer answers are compared exactly.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import analysis as ref_analysis  # noqa: E402
from repro.core import registry as ref_registry  # noqa: E402
from repro.core.memento import MementoWrapper as RefWrapper  # noqa: E402
from repro.placement.elastic import FailureDomain as RefDomain  # noqa: E402
from repro.serving.router import SessionRouter as RefRouter  # noqa: E402
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.memento import MementoWrapper  # noqa: E402
from repro_torch.placement.elastic import FailureDomain  # noqa: E402
from repro_torch.serving.router import SessionRouter  # noqa: E402

KEYS = [int(k) for k in np.random.default_rng(0).integers(0, 2**64, size=400, dtype=np.uint64)]


# -- the default resolution ---------------------------------------------------


def test_default_session_router_routes_like_reference():
    """``SessionRouter(100)`` with no keywords, replicas 3, 17 and 42
    failed: every one of 20,000 sessions on the reference's replica."""
    port, ref = SessionRouter(100), RefRouter(100)
    for b in (3, 17, 42):
        port.fail(b), ref.fail(b)
    assert port.domain._eng.resolve == ref.domain._eng.resolve == "chain"
    assert port.domain._eng.chain_bits == ref.domain._eng.chain_bits == 64
    assert port.domain._eng.max_chain == ref.domain._eng.max_chain == 4096
    assert (port.domain.resolve, port.domain.chain_bits, port.domain.max_chain) == ("chain", 64, 4096)
    ids = [f"s{i}" for i in range(20_000)]
    assert [port.route(i) for i in ids] == [ref.route(i) for i in ids]


@pytest.mark.parametrize("make_domain", [FailureDomain, RefDomain], ids=["port", "reference"])
def test_default_domain_refuses_to_fail_the_last_alive(make_domain):
    d = make_domain(3)
    d.fail(0), d.fail(1)
    with pytest.raises(ValueError, match="last alive bucket"):
        d.fail(2)
    assert d.alive_count == 1 and d.locate(12345) == 2


def test_chain_domain_has_no_table():
    for d in (FailureDomain(8), RefDomain(8)):
        with pytest.raises(ValueError, match="resolve='table'"):
            d.replacement_table


# -- chain mode against the reference ----------------------------------------


def _events(n, seed):
    """A fail / recover / scale sequence over ``n`` slots (never the
    last slot id, never the last alive one)."""
    rng = np.random.default_rng(seed)
    removed, out = set(), []
    for _ in range(40):
        alive = [b for b in range(n - 1) if b not in removed]
        r = rng.random()
        if r < 0.55 and len(alive) > 1:
            b = int(rng.choice(alive))
            removed.add(b)
            out.append(("fail", b))
        elif r < 0.75 and removed:
            b = int(rng.choice(sorted(removed)))
            removed.discard(b)
            out.append(("recover", b))
        elif r < 0.9:
            out.append(("scale_up",))
            n += 1
        elif n - 1 not in removed and n > 2 and len(alive) > 1:
            out.append(("scale_down",))
            n -= 1
            removed = {b for b in removed if b < n}
    return out


def _same(port, ref, locate="locate"):
    assert [getattr(port, locate)(k) for k in KEYS] == [getattr(ref, locate)(k) for k in KEYS]


@pytest.mark.parametrize("max_chain", [0, 1, 2, 4096])
@pytest.mark.parametrize("chain_bits,engine", [(32, "binomial32"), (32, "jump32"),
                                               (64, "binomial"), (64, "jump")])
def test_failure_domain_chain_mode_matches_reference(chain_bits, engine, max_chain):
    kw = dict(engine=engine, chain_bits=chain_bits, max_chain=max_chain, resolve="chain")
    port, ref = FailureDomain(60, **kw), RefDomain(60, **kw)
    _same(port, ref)
    for event in _events(60, chain_bits + max_chain):
        assert getattr(port, event[0])(*event[1:]) == getattr(ref, event[0])(*event[1:])
        assert (port.removed, port.total_count, port.alive_count) == (
            ref.removed, ref.total_count, ref.alive_count)
        assert port.first_alive() == ref.first_alive()
        _same(port, ref)


@pytest.mark.parametrize("max_chain", [0, 1, 2, 4096])
@pytest.mark.parametrize("chain_bits", [32, 64])
def test_memento_wrapper_chain_mode_matches_reference(chain_bits, max_chain):
    engine = "binomial32" if chain_bits == 32 else "binomial"
    port = MementoWrapper(lambda m: registry.make(engine, m), 40, max_chain, chain_bits)
    ref = RefWrapper(lambda m: ref_registry.make(engine, m), 40, max_chain, chain_bits)
    for b in range(0, 39, 3):  # a third failed
        port.remove_bucket(b), ref.remove_bucket(b)
    _same(port, ref, "get_bucket")
    port.restore_bucket(3), ref.restore_bucket(3)
    assert port.add_bucket() == ref.add_bucket()
    _same(port, ref, "get_bucket")
    assert port.remove_bucket() == ref.remove_bucket()
    assert port.alive() == ref.alive()
    _same(port, ref, "get_bucket")


@pytest.mark.parametrize("allow_empty", [False, True])
@pytest.mark.parametrize("chain_bits", [32, 64])
def test_session_router_chain_mode_matches_reference(chain_bits, allow_empty):
    kw = dict(engine="binomial32" if chain_bits == 32 else "binomial", chain_bits=chain_bits,
              allow_empty=allow_empty)
    port, ref = SessionRouter(20, **kw), RefRouter(20, **kw)
    ids = [f"user-{i}" for i in range(3000)]
    for victim in range(19):
        port.fail(victim), ref.fail(victim)
        assert [port.route(i) for i in ids] == [ref.route(i) for i in ids]
    assert port.stats.moved_sessions == ref.stats.moved_sessions
    if not allow_empty:  # the last alive replica may not fail
        for r in (port, ref):
            with pytest.raises(ValueError, match="last alive bucket"):
                r.fail(19)
        return
    port.fail(19), ref.fail(19)
    assert port.domain.alive_count == ref.domain.alive_count == 0
    for r in (port, ref):
        with pytest.raises(Exception) as err:
            r.route("user-0")
        assert type(err.value).__name__ == "FleetUnavailableError"


def test_constructors_validate_like_reference():
    for cls in (MementoWrapper, RefWrapper):
        with pytest.raises(ValueError, match="chain_bits"):
            cls(lambda m: registry.make("binomial", m), 4, chain_bits=16)
        with pytest.raises(ValueError, match="resolve"):
            cls(lambda m: registry.make("binomial", m), 4, resolve="walk")


# -- the registry --------------------------------------------------------------


def test_registry_tables_match_reference():
    assert list(registry.ENGINES) == list(ref_registry.ENGINES)
    assert registry.CONSTANT_TIME == ref_registry.CONSTANT_TIME
    assert registry.FULLY_CONSISTENT == ref_registry.FULLY_CONSISTENT
    assert sorted(registry.BULK_ENGINES) == sorted(ref_registry.BULK_ENGINES)
    with pytest.raises(KeyError, match="unknown engine"):
        registry.make("nope", 4)


def _answers(engine, keys):
    return [engine.get_bucket(k) for k in keys]


@pytest.mark.parametrize("name", list(ref_registry.ENGINES))
def test_engine_matches_reference(name):
    """Built at every n in 1..300 (the ring, whose constructor is n
    ``add_bucket`` calls, grown to each n), then grown from 150 to 300 by
    ``add_bucket`` (the anchor's and dx's capacity at 150 is 300 and 512)
    and shrunk back to 150 by ``remove_bucket``: the same bucket for every
    key at every size, and the same facade fields."""
    keys = KEYS[:16]
    grown = (registry.make(name, 0), ref_registry.make(name, 0)) if name == "ring" else None
    for n in range(1, 301):
        if name == "ring":
            assert grown[0].add_bucket() == grown[1].add_bucket()
            port, ref = grown
        else:
            port, ref = registry.make(name, n), ref_registry.make(name, n)
        assert (port.size, port.name, port.exact) == (ref.size, ref.name, ref.exact) == (
            port.size, name, port.exact)
        assert _answers(port, keys) == _answers(ref, keys)
    port, ref = registry.make(name, 150), ref_registry.make(name, 150)
    for _ in range(150):
        assert port.add_bucket() == ref.add_bucket()
        assert _answers(port, keys) == _answers(ref, keys)
    for _ in range(150):
        assert port.remove_bucket() == ref.remove_bucket()
        assert port.size == ref.size and _answers(port, keys) == _answers(ref, keys)


# -- the balance theory --------------------------------------------------------


def _close(a, b):
    assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (a, b)


@pytest.mark.parametrize("omega", [1, 4, 16, 64])
def test_analysis_matches_reference(omega):
    for n in list(range(2, 300)) + [1000, 1023, 1024, 1025, 10_000, 100_000]:
        assert analysis.tree_bounds(n) == ref_analysis.tree_bounds(n)
        _close(analysis.p_lowest_level(n, omega), ref_analysis.p_lowest_level(n, omega))
        for a, b in zip(analysis.expected_keys(n, 1000 * n, omega),
                        ref_analysis.expected_keys(n, 1000 * n, omega)):
            _close(a, b)
        _close(analysis.relative_imbalance(n, omega), ref_analysis.relative_imbalance(n, omega))
        _close(analysis.sigma(n, 1000 * n, omega), ref_analysis.sigma(n, 1000 * n, omega))
    for q in (1.0, 1000.0):
        _close(analysis.sigma_max(q, omega), ref_analysis.sigma_max(q, omega))
    for M in (1, 512, 1 << 20):
        _close(analysis.sigma_argmax(M, omega), ref_analysis.sigma_argmax(M, omega))
    for mod in (analysis, ref_analysis):
        with pytest.raises(ValueError):
            mod.tree_bounds(1)
