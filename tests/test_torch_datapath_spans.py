"""The bulk datapath's spans (``SpanTrace`` attached as ``BatchRouter.tracer``),
on the CPU: the tree each call records (``route_keys``, ``place_keys``, a
burst of fleet events, ``plan_migration``), ids, parents and trace ids,
self times, totals that outlive the ring, nothing recorded and no clock
read without a tracer, and answers bit-identical with one.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.observability import trace as T  # noqa: E402
from repro_torch.observability.trace import NestedSpan, SpanTrace  # noqa: E402
from repro_torch.placement.store import StorePlacement  # noqa: E402
from repro_torch.serving.batch_router import BatchRouter  # noqa: E402
from repro_torch.serving.lifecycle.errors import FleetUnavailableError  # noqa: E402

ENGINES = ("binomial", "jump")
CALLS = ("route_keys", "place_keys", "burst", "plan_migration")
KEYS = np.random.default_rng(7).integers(0, 1 << 32, size=2048, dtype=np.uint32)

#: the children each root records, in order
CHILDREN = {
    "route_keys": [T.SPAN_ROUTE_GUARD, T.SPAN_ROUTE_COERCE, T.SPAN_ROUTE_LAUNCH],
    "place_keys": [T.SPAN_PLACE_GUARD, T.SPAN_PLACE_COERCE, T.SPAN_PLACE_LAUNCH],
    "plan_migration": [T.SPAN_PLAN_KEYS_UP, T.SPAN_PLAN_FLEET_UP, T.SPAN_PLAN_DIFF,
                       T.SPAN_PLAN_COPY_BACK],
}


def _store(engine, tracer=None):
    router = BatchRouter(60, engine=engine, capacity=64, device="cpu", tracer=tracer)
    for s in (4, 9, 17):
        router.fail(s)
    store = StorePlacement(router, r=3)
    store.register(KEYS[:512])
    return router, store


def _keys():
    return torch.from_numpy(KEYS.view(np.int32).copy())


def _drive(call, router, store, n_events=3):
    """One ``call`` on a router (and its store) -> its answer, as numpy."""
    if call == "route_keys":
        return router.route_keys(_keys()).numpy()
    if call == "place_keys":
        rep, exhausted = store.place_keys(_keys())
        return np.concatenate([rep.numpy().reshape(-1), exhausted.numpy().astype(np.int32)])
    before = store._fleet_snapshot()
    with router.coalesced_events():
        for s in (20, 30, 40)[:n_events]:
            router.fail(s)
    if call == "burst":
        f = router._fleet_dev
        return np.concatenate([f.packed.numpy(), f.table.numpy(), f.state.numpy()])
    plan = store.plan_migration(before)
    return np.concatenate([plan.old.reshape(-1), plan.new.reshape(-1),
                           plan.moved.reshape(-1).astype(np.int32)])


def _traced(engine, call, **kw):
    tracer = SpanTrace(1 << 12)
    router, store = _store(engine, tracer)
    mark = tracer.total
    epoch, calls = router.routing_epoch, router.traced_calls
    _drive(call, router, store, **kw)
    spans = tracer.spans()[mark:]
    assert not tracer._stack, "a stage was left open"
    return spans, epoch, calls, tracer


def _roots(spans, name):
    return [s for s in spans if s.name == name and s.parent_id == 0]


def _children(spans, parent):
    return sorted((s for s in spans if s.parent_id == parent.span_id), key=lambda s: s.span_id)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("call", ["route_keys", "place_keys", "plan_migration"])
def test_a_call_records_its_stages_in_order_inside_it(engine, call):
    spans, epoch, calls, _ = _traced(engine, call)
    (root,) = _roots(spans, call)
    kids = _children(spans, root)
    assert [k.name for k in kids] == CHILDREN[call]
    assert all(isinstance(s, NestedSpan) for s in spans)
    # each stage inside its root, one after the other
    t = root.t_start_ns
    for k in kids:
        assert t <= k.t_start_ns <= k.t_end_ns <= root.t_end_ns
        t = k.t_end_ns
    # a replan is named by the epoch it began at, after the burst's 3 events
    want = epoch + 3 if call == "plan_migration" else calls + 1
    assert {s.trace_id for s in spans if s.name.startswith(call)} == {want}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n_events", [1, 3])
def test_a_burst_records_each_event_then_one_flush_and_one_upload(engine, n_events):
    spans, epoch, _, _ = _traced(engine, "burst", n_events=n_events)
    (root,) = _roots(spans, T.SPAN_BURST)
    kids = _children(spans, root)
    assert [k.name for k in kids] == [T.SPAN_BURST_EVENT] * n_events + [T.SPAN_BURST_FLUSH]
    (upload,) = [s for s in spans if s.name == T.SPAN_FLEET_UPLOAD]
    assert upload.parent_id == kids[-1].span_id
    assert {s.trace_id for s in spans} == {epoch}
    assert len(spans) == n_events + 3


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("call", CALLS)
def test_ids_parents_and_self_times(engine, call):
    spans, _, _, _ = _traced(engine, call)
    ids = [s.span_id for s in spans]
    assert len(set(ids)) == len(ids) and min(ids) > 0
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.t_end_ns >= s.t_start_ns and s.duration_ns >= 0
        assert (s.t_start_us, s.t_end_us) == (s.t_start_ns // 1000, s.t_end_ns // 1000)
        if s.parent_id:
            parent = by_id[s.parent_id]
            assert parent.span_id < s.span_id and parent.trace_id == s.trace_id
            assert parent.t_start_ns <= s.t_start_ns <= s.t_end_ns <= parent.t_end_ns
    for s in spans:
        own = s.duration_ns - sum(k.duration_ns for k in _children(spans, s))
        assert own >= 0


@pytest.mark.parametrize("engine", ENGINES)
def test_an_upload_outside_a_burst_is_a_root_named_by_its_epoch(engine):
    tracer = SpanTrace(64)
    router = BatchRouter(60, engine=engine, capacity=64, device="cpu", tracer=tracer)
    router.fail(5)
    s = tracer.spans()[-1]
    assert (s.name, s.parent_id, s.trace_id) == (T.SPAN_FLEET_UPLOAD, 0, router.routing_epoch)
    assert tracer.count(T.SPAN_BURST_EVENT) == 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("call", CALLS)
def test_totals_outlive_the_ring(engine, call):
    tracer = SpanTrace(3)
    router, store = _store(engine, tracer)
    before = tracer.totals()
    for _ in range(4):
        _drive(call, router, store)
        if call in ("burst", "plan_migration"):
            with router.coalesced_events():
                for s in (20, 30, 40):
                    router.recover(s)
    # a burst's four rounds each fail three slots, then recover them
    root, rounds = (T.SPAN_BURST, 8) if call == "burst" else (call, 4)
    count, ns = tracer.totals()[root]
    assert count - before.get(root, (0, 0))[0] == rounds and ns > 0
    assert tracer.dropped == tracer.total - 3 > 0 and len(tracer.spans()) == 3
    assert (tracer.count(root), tracer.total_ns(root)) == (count, ns)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("call", CALLS)
def test_without_a_tracer_nothing_is_recorded_and_no_clock_read(engine, call, monkeypatch):
    router, store = _store(engine)
    assert router.tracer is None

    def no_clock():
        raise AssertionError("a clock was read")

    for mod, name in ((T, "_now"), (time, "perf_counter_ns"), (time, "perf_counter"),
                      (time, "monotonic"), (time, "time")):
        monkeypatch.setattr(mod, name, no_clock)
    _drive(call, router, store)
    assert router.traced_calls == 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("call", CALLS)
def test_answers_with_a_tracer_are_bit_identical(engine, call):
    plain = _drive(call, *_store(engine))
    tracer = SpanTrace(1 << 10)
    traced = _drive(call, *_store(engine, tracer))
    assert tracer.count() > 0
    np.testing.assert_array_equal(traced, plain)


@pytest.mark.parametrize("engine", ENGINES)
def test_a_stage_an_error_leaves_open_closes_with_its_root(engine):
    tracer = SpanTrace(64)
    router = BatchRouter(2, engine=engine, capacity=64, device="cpu", tracer=tracer)
    with router.coalesced_events():
        router.fail(0)
        router.fail(1)
    with pytest.raises(FleetUnavailableError):
        router.route_keys(_keys())
    assert not tracer._stack
    root, guard = tracer.spans(T.SPAN_ROUTE_KEYS)[-1], tracer.spans(T.SPAN_ROUTE_GUARD)[-1]
    assert guard.parent_id == root.span_id and guard.t_end_ns == root.t_end_ns
    router.recover(1)
    router.route_keys(_keys())
    assert tracer.spans()[-1].name == T.SPAN_ROUTE_KEYS and tracer.spans()[-1].parent_id == 0


def test_nested_and_stage_spans_share_one_ring_and_one_set_of_totals():
    tracer = SpanTrace(8)
    tracer.record(T.SPAN_ADMIT, 10, 12, tenant="a")
    sid = tracer.open("outer", trace_id=5)
    tracer.open("inner")
    tracer.next("inner2")
    tracer.close(sid)
    names = [s.name for s in tracer.spans()]
    assert names == [T.SPAN_ADMIT, "inner", "inner2", "outer"]
    assert tracer.total_ns(T.SPAN_ADMIT) == 2000 and tracer.count("inner2") == 1
    assert {s.trace_id for s in tracer.spans() if isinstance(s, NestedSpan)} == {5}
    assert type(tracer.spans()[0]) is T.Span
