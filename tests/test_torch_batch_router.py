"""The port's ``BatchRouter(device="cpu")`` against the JAX package's
``BatchRouter`` over the same seeded fleet-event streams: fail, recover,
scale up/down, failing the last slot (a LIFO shrink), coalesced bursts and
the all-failed fleet.  After every event both routers must agree, bit for
bit, on ``route_keys``, ``route_ids``, ``route_batch`` (str, int and mixed
ids), ``routing_epoch`` and ``stats`` — fused and two-pass."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.serving.batch_router import BatchRouter as RefRouter  # noqa: E402
from repro.serving.lifecycle.errors import (  # noqa: E402
    FleetUnavailableError as RefUnavailable,
)
from repro_torch.core.bulk import RouterSpec  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402
from repro_torch.serving.lifecycle.errors import FleetUnavailableError  # noqa: E402


def _pair(n, engine, fused, **kw):
    return (
        RefRouter(n, engine=engine, fused=fused, **kw),
        BatchRouter(n, engine=engine, fused=fused, device="cpu", **kw),
    )


def _stats(r):
    s = r.stats
    return s.lookups, s.moved_sessions, list(s.events)


def _agree(ref, port, rng):
    """Every route entry point and the counters agree."""
    keys = rng.integers(0, 2**64, size=777, dtype=np.uint64)
    np.testing.assert_array_equal(port.route_keys_np(keys), ref.route_keys_np(keys))
    keys32 = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    got = port.route_keys(torch.from_numpy(keys32.view(np.int32)))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref.route_keys_np(keys32))
    ids = rng.integers(0, 2**64, size=500, dtype=np.uint64)
    np.testing.assert_array_equal(port.route_ids(ids).numpy(), np.asarray(ref.route_ids(ids)))
    strs = [f"session-{i}-{rng.integers(1 << 30)}" for i in range(64)]
    np.testing.assert_array_equal(port.route_batch(strs), ref.route_batch(strs))
    ints = [int(x) for x in rng.integers(-(2**40), 2**40, size=64)]
    np.testing.assert_array_equal(port.route_batch(ints), ref.route_batch(ints))
    mixed = [s if i % 3 else int(i) * 7919 for i, s in enumerate(strs)] + ["ünïcödé", ""]
    np.testing.assert_array_equal(port.route_batch(mixed), ref.route_batch(mixed))
    assert port.route("a-session") == ref.route("a-session")
    assert port.routing_epoch == ref.routing_epoch
    assert port.alive == ref.alive
    assert _stats(port) == _stats(ref)


def _random_event(ref, port, rng):
    """Apply one random valid fleet event to both routers."""
    dom = ref.domain
    total, removed = dom.total_count, sorted(dom.removed)
    alive = [b for b in range(total) if b not in dom.removed]
    roll = rng.random()
    if removed and roll < 0.3:
        b = int(rng.choice(removed))
        ref.recover(b), port.recover(b)
    elif roll < 0.45 and total < ref.capacity:
        assert port.scale_up() == ref.scale_up()
    elif roll < 0.6 and ref.alive > 1 and total > 1:
        assert port.scale_down() == ref.scale_down()
    elif ref.alive > 1:
        # includes failing the last slot id: a LIFO shrink + wholesale resync
        b = int(rng.choice(alive))
        ref.fail(b), port.fail(b)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("engine", ["binomial", "jump"])
@pytest.mark.parametrize("seed", [0, 1])
def test_event_stream_parity(engine, fused, seed):
    rng = np.random.default_rng(seed)
    ref, port = _pair(12, engine, fused, capacity=32)
    _agree(ref, port, rng)
    for _ in range(14):
        _random_event(ref, port, rng)
        _agree(ref, port, rng)


@pytest.mark.parametrize("engine", ["binomial", "jump"])
def test_coalesced_burst_parity(engine):
    rng = np.random.default_rng(3)
    ref, port = _pair(40, engine, True, capacity=64)
    for _ in range(3):
        with ref.coalesced_events(), port.coalesced_events():
            for _ in range(6):
                _random_event(ref, port, rng)
            # a route inside the burst flushes defensively
            _agree(ref, port, rng)
        _agree(ref, port, rng)


@pytest.mark.parametrize("engine", ["binomial", "jump"])
def test_last_slot_fail_and_storm(engine):
    """Fail the last slot id (slot space shrinks), then fail most of the
    fleet: the deep redirect runs on many keys."""
    rng = np.random.default_rng(4)
    ref, port = _pair(64, engine, True, capacity=64, omega=8)
    ref.fail(63), port.fail(63)
    _agree(ref, port, rng)
    for b in rng.choice(62, size=45, replace=False):
        ref.fail(int(b)), port.fail(int(b))
    _agree(ref, port, rng)


@pytest.mark.parametrize("fused", [True, False])
def test_all_failed_fleet_raises_typed(fused):
    ref, port = _pair(3, "binomial", fused)
    for b in (0, 1, 2):
        ref.fail(b), port.fail(b)
    assert port.alive == ref.alive == 0
    for call in ("route_keys", "route_ids", "route_batch"):
        arg = [1, 2] if call == "route_batch" else np.arange(4, dtype=np.uint64)
        with pytest.raises(RefUnavailable):
            getattr(ref, call)(arg)
        with pytest.raises(FleetUnavailableError, match="epoch 3"):
            getattr(port, call)(arg)
    ref.recover(1), port.recover(1)
    _agree(ref, port, np.random.default_rng(5))


@pytest.mark.parametrize("fused", [True, False])
def test_zero_row_batches(fused):
    _, port = _pair(5, "jump", fused)
    assert port.route_keys(np.zeros((0,), np.uint32)).shape == (0,)
    assert port.route_keys(torch.zeros((2, 0), dtype=torch.int32)).shape == (2, 0)
    assert port.route_ids(np.zeros((0,), np.uint64)).dtype == torch.int32
    assert port.route_batch([]).shape == (0,)
    assert port.stats.lookups == 0


def test_key_dtypes_truncate_like_the_oracle():
    """Any int keys route as their low 32 bits, tensor or array."""
    ref, port = _pair(9, "binomial", True)
    wide = np.array([0, 1, 2**32 + 5, 2**63 + 7, 2**64 - 1], dtype=np.uint64)
    expect = ref.route_keys_np(wide)
    np.testing.assert_array_equal(port.route_keys_np(wide), expect)
    as_i64 = torch.from_numpy(wide.view(np.int64))
    np.testing.assert_array_equal(port.route_keys(as_i64).numpy(), expect)
    grid = np.arange(12, dtype=np.uint32).reshape(3, 4)
    np.testing.assert_array_equal(port.route_keys_np(grid), ref.route_keys_np(grid))


def test_spec_and_constructor_validation():
    port = BatchRouter(4, engine="jump", capacity=16, omega=5, device="cpu")
    assert (port.engine, port.capacity, port.omega, port.n_words) == ("jump", 16, 5, 1)
    assert port.spec == RouterSpec(engine="jump", capacity=16, omega=5)
    assert BatchRouter(100, device="cpu").capacity == 256
    with pytest.raises(ValueError, match="exceeds capacity"):
        BatchRouter(100, capacity=64, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        RouterSpec(capacity=48)
    with pytest.raises(KeyError, match="unknown bulk engine"):
        BatchRouter(4, engine="ring", device="cpu")
    with pytest.raises(ValueError, match="device-table capacity"):
        full = BatchRouter(64, capacity=64, device="cpu")
        full.scale_up()


def test_failure_moves_only_the_victims_keys():
    keys = np.random.default_rng(6).integers(0, 2**32, size=20000, dtype=np.uint32)
    _, port = _pair(50, "binomial", True, capacity=64)
    before = port.route_keys_np(keys)
    port.fail(17)
    after = port.route_keys_np(keys)
    moved = before != after
    assert moved.any() and (before[moved] == 17).all() and not (after == 17).any()
