"""The device's timeline from ``torch.profiler``: what ran on the card, when.

A traced run records device activity only (kernels, copies, sets), so a
window of some hundred thousand kernels stays cheap to record and to read.
``Timeline`` turns the profiler's events into intervals on one clock and
gives the busy time (the union of the intervals), time by operation name
and the longest gaps in which the card ran nothing.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict


class Timeline:
    """Device operations as (name, start_s, end_s), sorted by start."""

    def __init__(self, ops):
        self.ops = sorted(ops, key=lambda o: o[1])

    @classmethod
    def from_profiler(cls, prof) -> "Timeline":
        ops = []
        for e in prof.profiler.kineto_results.events():
            if "cuda" not in str(e.device_type()).lower():
                continue
            start, dur = e.start_ns(), e.duration_ns()
            if dur > 0:
                ops.append((e.name(), start * 1e-9, (start + dur) * 1e-9))
        return cls(ops)

    def busy_s(self) -> float:
        """Seconds in which at least one operation ran."""
        total, end = 0.0, None
        for _, s, e in self.ops:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            out[name] += e - s
        return dict(out)

    def matching(self, fragment: str) -> tuple[int, float]:
        """(launches, seconds) of the operations whose name holds ``fragment``."""
        n, sec = 0, 0.0
        for name, s, e in self.ops:
            if fragment in name:
                n += 1
                sec += e - s
        return n, sec

    def kernel_seconds(self) -> float:
        return sum(e - s for _, s, e in self.ops)

    def idle_gaps(self, top: int = 10):
        """The longest gaps between operations, each named by the
        operations either side of it."""
        gaps, end, prev = [], None, None
        for name, s, e in self.ops:
            if end is not None and s > end:
                gaps.append((f"after {prev[:60]} / before {name[:60]}", s - end))
            if end is None or e > end:
                end, prev = e, name
        return [[label, sec] for label, sec in sorted(gaps, key=lambda g: -g[1])[:top]]


@contextlib.contextmanager
def device_trace(enabled: bool):
    """Profile device activity inside the block; yields a list that holds
    the ``Timeline`` once the block has ended (empty when not enabled)."""
    box: list = []
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield box
    box.append(Timeline.from_profiler(prof))


def breakdown(timeline: Timeline, top: int = 10) -> dict:
    """The trace as the result line carries it: the device operations that
    took most time and the longest idle gaps, in seconds."""
    by_name = sorted(timeline.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], sec] for name, sec in by_name],
            "idle_gaps": timeline.idle_gaps(top)}
