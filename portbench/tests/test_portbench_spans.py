"""``portbench/spans.py`` on a hand-made window: a device ``Timeline`` and
the port's spans on one clock, at the magnitude of Unix-epoch nanoseconds,
with every answer counted by hand."""

import pytest

from portbench import spans as S
from portbench.harness import load_module
from portbench.trace import Timeline

BASE = 1_800_000_000 * 10**9  # ns: the clock of the profiler and of time.time_ns()


def _ns(ms: float) -> int:
    return BASE + int(round(ms * 1e6))


def _s(ms: float) -> float:
    return _ns(ms) * 1e-9


def _span(name, start_ms, end_ms, device_ms=None):
    return (name, _ns(start_ms), _ns(end_ms), device_ms)


SPANS = [
    _span("train.feed", 5, 10),
    _span("train.step", 10, 40, 29.0),
    _span("train.forward", 12, 20, 7.0),
    _span("train.backward", 20, 35, 14.0),
    _span("train.optimizer", 35, 39, 1.0),
    _span("train.feed", 45, 50),
    _span("train.step", 50, 80, 27.0),
    _span("train.forward", 52, 60, 9.0),
    _span("train.backward", 60, 72, 16.0),
    _span("train.optimizer", 72, 79, 3.0),
    _span("train.pull", 85, 95),
]
OPS = [("conv", 15, 38), ("fused_adam_kernel", 38, 41), ("conv", 55, 75),
       ("fused_adam_kernel", 76, 78)]


def _readings(ops=OPS, spans=SPANS):
    return {"kind": "train", "steps": 2, "window_s": 0.1,
            "timeline": Timeline([(n, _s(a), _s(b)) for n, a, b in ops]),
            "spans": list(spans), "span_window_ns": (_ns(0), _ns(100))}


def test_phases_and_feed_by_hand():
    r = _readings()
    assert S.phase_ms_per_step(r, "train.forward") == pytest.approx(8.0)
    assert S.phase_ms_per_step(r, "train.backward") == pytest.approx(15.0)
    assert S.phase_ms_per_step(r, "train.optimizer") == pytest.approx(2.0)
    assert S.feed_ms_per_step(r) == pytest.approx(5.0, abs=1e-6)
    # a span with no device time (the event pool ran dry): no mean
    dry = [s if s[0] != "train.forward" or s[1] != _ns(12) else s[:3] + (None,) for s in SPANS]
    assert S.phase_ms_per_step(_readings(spans=dry), "train.forward") is None


def test_loop_idle_counts_idle_outside_the_steps_only():
    r = _readings()
    # busy [15, 41] + [55, 75] + [76, 78] = 48 ms; idle outside both steps
    # [0, 10] + [41, 50] + [80, 100] = 39 ms of 100
    assert S.loop_idle_pct(r) == pytest.approx(39.0, abs=1e-3)
    device_idle = load_module("metrics", "device_idle_pct.train").read(r)
    assert device_idle == pytest.approx(52.0, abs=1e-3)
    assert 0.0 <= S.loop_idle_pct(r) <= device_idle
    # idle that falls inside a step is the step's launches, not the loop's
    busier = OPS + [("copy", 0, 10), ("copy", 41, 50), ("copy", 80, 100)]
    assert S.loop_idle_pct(_readings(ops=busier)) == pytest.approx(0.0, abs=1e-3)
    assert load_module("metrics", "device_idle_pct.train").read(_readings(ops=busier)) \
        == pytest.approx(13.0, abs=1e-3)


def test_idle_goes_to_the_innermost_open_span():
    got = S.idle_ms_by_span(_readings())
    want = {"none": 19.0, "train.feed": 10.0, "train.pull": 10.0, "train.forward": 6.0,
            "train.step": 5.0, "train.optimizer": 2.0}
    assert got == pytest.approx(want, abs=1e-3)
    assert sum(got.values()) == pytest.approx(52.0, abs=1e-3)
    assert list(got)[0] == "none"  # largest first


def test_the_shared_clock_check():
    check = S.optimizer_causality(_readings())
    assert check["pairs"] == 2 and check["violations"] == 0
    assert check["smallest_margin_ms"] == pytest.approx(3.0, abs=1e-3)
    # device operations on a clock 10 ms early start before the host asked
    early = [(n, a - 10, b - 10) for n, a, b in OPS]
    check = S.optimizer_causality(_readings(ops=early))
    assert check["violations"] == 2
    assert check["smallest_margin_ms"] == pytest.approx(-7.0, abs=1e-3)


@pytest.mark.parametrize("read", [
    lambda r: S.phase_ms_per_step(r, "train.forward"), S.feed_ms_per_step, S.loop_idle_pct,
    S.idle_ms_by_span, S.optimizer_causality])
def test_nothing_to_read_gives_none(read):
    assert read({}) is None
    without = _readings()
    without.pop("spans")
    assert read(without) is None
    assert read({**_readings(), "spans": []}) is None
