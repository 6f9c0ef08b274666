"""What the port's own spans say about a traced training window.

The port's tracer (``neural_sound_generation_tpu_torch.utils.profiling``)
records ``train.feed``, ``train.step`` with ``train.forward``,
``train.backward`` and ``train.optimizer`` inside it, and ``train.pull``,
each with its host instants on ``time.time_ns()`` (the clock of the
profiler's events) and the device milliseconds between its two CUDA events.
The functions here read a training window's ``readings`` that carry, beside
the device ``Timeline`` (``portbench/trace.py``) and ``steps``, what the
tracer's ``drain()`` returned: ``spans``, a list of ``(name, start_ns,
end_ns, device_ms)``, and ``span_window_ns``, the instants the tracer was
turned on and off. Each returns None where the readings hold nothing for
it. They are the readers of five span metrics, for a training driver of
``portbench/drivers/`` that hands the tracer's spans over (PERF.md §7).
"""

from __future__ import annotations

STEP = "train.step"
PHASES = ("train.forward", "train.backward", "train.optimizer")
NONE = "none"  # outside every span


def named(r: dict, name: str | None = None) -> list:
    """The readings' spans called ``name`` (every span without one)."""
    spans = r.get("spans") or []
    return [s for s in spans if name is None or s[0] == name]


def _window_s(r: dict):
    w = r.get("span_window_ns")
    if not w or w[0] is None or w[1] is None or w[1] <= w[0]:
        return None
    return w[0] * 1e-9, w[1] * 1e-9


def phase_ms_per_step(r: dict, name: str):
    """Mean device milliseconds between the events of the spans ``name``
    (one a step); None without such spans or without their device time."""
    ms = [s[3] for s in named(r, name)]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(ms)


def feed_ms_per_step(r: dict):
    """Host milliseconds in ``train.feed`` over the window's steps (the
    ``train.step`` spans)."""
    feeds, steps = named(r, "train.feed"), named(r, STEP)
    if not feeds or not steps:
        return None
    return 1e-6 * sum(s[2] - s[1] for s in feeds) / len(steps)


def _merged(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted(intervals, key=lambda i: i[0]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _busy(r: dict, lo: float, hi: float) -> list:
    return _merged(((s, e) for _, s, e in r["timeline"].ops), lo, hi)


def loop_idle_pct(r: dict):
    """Percent of the span window in which the card runs nothing and the
    host is outside every ``train.step`` span: the idle time that the loop
    around the step (feed, pulls, log lines) leaves, not the launches
    inside a step."""
    window, steps = _window_s(r), named(r, STEP)
    if window is None or not steps or r.get("timeline") is None:
        return None
    lo, hi = window
    held = _busy(r, lo, hi) + [(s[1] * 1e-9, s[2] * 1e-9) for s in steps]
    return 100.0 * (1.0 - _length(_merged(held, lo, hi)) / (hi - lo))


def innermost_pieces(spans, lo: float, hi: float) -> list:
    """[(start, end, name)] covering [lo, hi]: the innermost span open in
    each piece, ``NONE`` outside every span. Spans of one thread nest."""
    bounds = []
    for i, s in enumerate(spans):
        bounds.append((s[1] * 1e-9, 1, i))
        bounds.append((s[2] * 1e-9, 0, i))
    bounds.sort(key=lambda b: (b[0], b[1]))
    pieces, stack, t = [], [], lo
    for at, opens, i in bounds:
        at = min(max(at, lo), hi)
        if at > t:
            pieces.append((t, at, spans[stack[-1]][0] if stack else NONE))
            t = at
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if hi > t:
        pieces.append((t, hi, spans[stack[-1]][0] if stack else NONE))
    return pieces


def idle_ms_by_span(r: dict):
    """The card's idle milliseconds in the span window, each instant put
    down to the innermost host span open then (``NONE`` outside every
    span), largest first."""
    window = _window_s(r)
    if window is None or r.get("timeline") is None or not named(r):
        return None
    lo, hi = window
    idle, t = [], lo
    for s, e in _busy(r, lo, hi):
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    out: dict[str, float] = {}
    pieces = innermost_pieces(named(r), lo, hi)
    j = 0
    for s, e in idle:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b = max(s, pieces[k][0]), min(e, pieces[k][1])
            if b > a:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + 1e3 * (b - a)
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def optimizer_causality(r: dict, fragment: str = "fused_adam"):
    """The shared clock's check: the k-th device operation whose name holds
    ``fragment`` against the k-th ``train.optimizer`` span, which launches
    it. ``{"pairs", "smallest_margin_ms", "violations"}``, a margin being
    the operation's start less the span's start (negative: the card ran it
    before the host asked, so the clocks disagree)."""
    spans, tl = named(r, "train.optimizer"), r.get("timeline")
    if not spans or tl is None:
        return None
    ops = [o for o in tl.ops if fragment in o[0]]
    margins = [1e3 * (o[1] - s[1] * 1e-9) for o, s in zip(ops, spans)]
    if not margins:
        return None
    return {"pairs": len(margins), "ops": len(ops), "spans": len(spans),
            "smallest_margin_ms": min(margins), "violations": sum(m < 0 for m in margins)}
