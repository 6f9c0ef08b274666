"""Tracing, spans and per-step timing.

Counterpart of ``neural_sound_generation_tpu/utils/profiling.py``:
``trace_context`` wraps a block in a named ``torch.profiler`` range and,
with a ``logdir``, writes a ``torch.profiler`` trace of it there (CPU
activity, and the card's where CUDA is available), readable by
TensorBoard's profiler plugin or as Chrome trace JSON; ``StepTimer``
aggregates blocked per-step wall times with percentile summaries.

``span(name)`` marks a block of the program (the training step's
``train.forward``, ``train.backward``, ``train.optimizer`` and
``train.step``, the loop's ``train.feed`` and ``train.pull``) for the
process's one tracer. The tracer is off until ``enable()``; off, a span
costs one flag check and touches no CUDA API. On, a span records its host
start and end on ``time.time_ns()``, the clock of the profiler's events, so
host spans and a ``torch.profiler`` trace of the card line up; records a
timing event on the current CUDA stream at entry and at exit, from a pool
made by ``enable()``, never synchronising; and opens
``torch.profiler.record_function(name)``, so a ``trace_context`` trace
shows the block too. ``drain()``, after the caller has synchronised,
returns the spans with each one's device milliseconds between its events
and the instants the tracer was turned on and off, and clears the tracer.
One thread records spans: the training loop's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_context(logdir: Optional[str] = None, name: str = "train"):
    """Profile the enclosed block. With ``logdir``, records a full
    ``torch.profiler`` trace and writes it there on exit; always annotates
    the block with ``record_function(name)``."""
    if not logdir:
        with torch.profiler.record_function(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir, worker_name=name),
    ):
        with torch.profiler.record_function(name):
            yield


class StepTimer:
    """Blocked wall-clock timing of train steps.

    The caller blocks inside the step, as JAX's ``block_until_ready`` does
    there: CUDA runs asynchronously, so call ``torch.cuda.synchronize()``
    before the step's block ends, or the timer reads the launch time::

        timer = StepTimer()
        for batch in loader:
            with timer.step():
                state, metrics = train_step(state, batch)
                torch.cuda.synchronize()
        print(timer.summary())
    """

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        """Stats over the recorded steps, the first ``skip_first`` (warm-up:
        kernel builds, allocator growth) left out."""
        times = np.asarray(self.times[skip_first:] or self.times)
        if len(times) == 0:
            return {}
        return {
            "steps": int(len(times)),
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p90_s": float(np.percentile(times, 90)),
            "steps_per_sec": float(1.0 / max(times.mean(), 1e-12)),
        }


class SpanRecord(NamedTuple):
    """One closed span: host instants on ``time.time_ns()``, and the device
    milliseconds between its two events (None off the card, or when the
    event pool ran dry)."""

    name: str
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


#: pairs of timing events made by ``enable()``: 6 spans a training step for
#: some 680 steps, far beyond a benchmark window
EVENT_PAIRS = 4096


class _Tracer:
    def __init__(self):
        self.on = False
        # [name, start_ns, end_ns or None, (start event, end event) or None];
        # end_ns stays None for a span still open or one whose block raised
        self.records: list = []
        self.window: List[Optional[int]] = [None, None]
        self.pool: list = []  # free pairs of timing events


_TRACER = _Tracer()


class _Off:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tracer = _TRACER
        events = tracer.pool.pop() if tracer.pool else None
        self.record = [self.name, time.time_ns(), None, events]
        tracer.records.append(self.record)
        if events is not None:
            events[0].record()
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        return None

    def __exit__(self, exc_type, exc, tb):
        self.annotation.__exit__(exc_type, exc, tb)
        record = self.record
        if record[3] is not None:
            record[3][1].record()
        if exc_type is None:
            record[2] = time.time_ns()
        return False


def span(name: str):
    """A context manager that records the block as ``name`` while the
    tracer is on, and does nothing while it is off. A block that raises
    (a feed that runs out with ``StopIteration``) is not recorded."""
    return _Span(name) if _TRACER.on else _OFF


def enable(device: torch.device | str | None = None) -> None:
    """Turn the tracer on. On a CUDA ``device`` the pool is filled to
    ``EVENT_PAIRS`` pairs of timing events, each recorded once here so that
    none is created while spans record (the CUDA event behind a
    ``torch.cuda.Event`` is made at its first record); a span that finds the
    pool empty records no device time."""
    tracer = _TRACER
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
        while len(tracer.pool) < EVENT_PAIRS:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record(stream)
            pair[1].record(stream)
            tracer.pool.append(pair)
    tracer.window = [time.time_ns(), None]
    tracer.on = True


def disable() -> None:
    """Turn the tracer off; what it recorded stays until ``drain()``."""
    if _TRACER.on:
        _TRACER.on = False
        _TRACER.window[1] = time.time_ns()


def drain() -> Dict[str, object]:
    """Turn the tracer off and return what it recorded, then clear it:
    ``{"spans": [SpanRecord, ...] in the order the spans began,
    "window_ns": (on, off)}``, both on ``time.time_ns()``. Call it after
    synchronising the device and once every span has closed: each span's
    device milliseconds are read from its events here."""
    disable()
    tracer = _TRACER
    spans = []
    for name, start_ns, end_ns, events in tracer.records:
        if end_ns is not None:
            device_ms = events[0].elapsed_time(events[1]) if events is not None else None
            spans.append(SpanRecord(name, start_ns, end_ns, device_ms))
        if events is not None:
            tracer.pool.append(events)
    window = tuple(tracer.window)
    tracer.records = []
    tracer.window = [None, None]
    return {"spans": spans, "window_ns": window}
