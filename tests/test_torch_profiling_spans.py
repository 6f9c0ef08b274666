"""The port's tracer (``utils/profiling.span``, ``enable``, ``disable``,
``drain``): off it records nothing and touches no CUDA API; on it records
nested spans in order on ``time.time_ns()``, the clock of the profiler's
events; ``drain()`` clears it."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neural_sound_generation_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _cleared_tracer():
    profiling.drain()
    yield
    profiling.drain()


def _refuse(*args, **kwargs):
    raise AssertionError("the tracer is off: no CUDA event, stream or profiler range")


def test_off_a_span_records_nothing_and_touches_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second  # one shared object: nothing made per span
    with first:
        with profiling.span("c"):
            torch.ones(4).sum()
    out = profiling.drain()
    assert out == {"spans": [], "window_ns": (None, None)}


def test_on_nested_spans_come_back_in_order():
    before = time.time_ns()
    profiling.enable()
    with profiling.span("outer"):
        with profiling.span("inner"):
            torch.ones(4).sum()
        with profiling.span("second"):
            pass
    profiling.disable()
    with profiling.span("after"):  # off again: not recorded
        pass
    out = profiling.drain()
    after = time.time_ns()
    names = [s.name for s in out["spans"]]
    assert names == ["outer", "inner", "second"]
    on, off = out["window_ns"]
    assert before <= on <= off <= after
    for s in out["spans"]:
        assert on <= s.start_ns <= s.end_ns <= off
        assert s.device_ms is None  # no card: no events
    outer, inner, second = out["spans"]
    assert outer.start_ns <= inner.start_ns and inner.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns


def test_drain_clears_the_tracer():
    profiling.enable()
    with profiling.span("x"):
        pass
    assert len(profiling.drain()["spans"]) == 1
    assert profiling.drain() == {"spans": [], "window_ns": (None, None)}
    with profiling.span("y"):  # drain turned the tracer off
        pass
    assert profiling.drain()["spans"] == []


def test_a_block_that_raises_is_not_recorded():
    profiling.enable()
    with pytest.raises(StopIteration):
        with profiling.span("feed"):
            next(iter(()))
    with profiling.span("kept"):
        pass
    assert [s.name for s in profiling.drain()["spans"]] == ["kept"]


def test_spans_share_the_profilers_clock():
    """A span around a ``record_function`` inside a CPU profile brackets
    that event's start to within 1 ms, and the span's own range is in the
    trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.enable()
        with profiling.span("train.unit"):
            with torch.profiler.record_function("inner.unit"):
                torch.ones(64).sum()
        out = profiling.drain()
    (unit,) = out["spans"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("inner.unit", "train.unit")}
    assert set(events) == {"inner.unit", "train.unit"}
    for event in events.values():
        assert unit.start_ns - 1_000_000 <= event.start_ns() <= unit.end_ns + 1_000_000
    inner = events["inner.unit"]
    assert unit.start_ns - 1_000_000 <= inner.start_ns() + inner.duration_ns() \
        <= unit.end_ns + 1_000_000
