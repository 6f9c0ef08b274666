"""Whole step: the model's forward and backward operations, counted from
shapes with no recompute (``counters``), times the window's steps, over the
window and the chip's peak for the cell's precision (TF32 tensor cores for
float32, bfloat16 for bfloat16), in percent. Moves ``train_audio_rate``."""

from portbench import counters


def read(r: dict):
    if r.get("kind") != "train" or not r.get("steps") or r.get("window_s", 0) <= 0:
        return None
    rate = r["step_flops"] * r["steps"] / r["window_s"]
    return 100.0 * rate / counters.PEAK_FLOPS[r["precision"]]
