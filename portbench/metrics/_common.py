"""Arithmetic that several readers share."""

from __future__ import annotations

from portbench import counters


def idle_pct(r: dict):
    """Percent of the traced window in which no operation ran on the card."""
    tl = r.get("timeline")
    if tl is None or r.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / r["window_s"])


def vq_nearest_share(r: dict):
    """Kernel 1's share of its roofline over the window: the searches' 2NKD
    operations and bytes, from the shapes its wrapper was handed, against
    the kernel's time in the trace. The search is float32 in every cell."""
    tl = r.get("timeline")
    if tl is None or not r.get("vq_calls"):
        return None
    launches, seconds = tl.matching("vq_nearest")
    if launches == 0:
        return None
    flops = sum(counters.vq_nearest_flops(*c) for c in r["vq_calls"])
    nbytes = sum(counters.vq_nearest_bytes(*c) for c in r["vq_calls"])
    return counters.kernel_share(flops, nbytes, seconds, "f32")
