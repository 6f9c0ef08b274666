"""Device: the percent of the traced training window in which no operation
ran on the card (the union of the trace's intervals against the window).
Moves ``train_audio_rate``."""

from portbench.metrics._common import idle_pct


def read(r: dict):
    return idle_pct(r) if r.get("kind") == "train" else None
