"""Trainer loop (``training/trainer.py``): the mean host milliseconds of a
call of the Trainer's step function over the window, from the harness's
span around each call (host clock, no synchronisation: the enqueue of a
step, and any wait for the launch queue or a metric pull inside it).
Moves ``train_audio_rate``."""


def read(r: dict):
    spans = r.get("step_host_s") if r.get("kind") == "train" else None
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
