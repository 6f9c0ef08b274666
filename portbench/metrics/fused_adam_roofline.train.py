"""Optimizer (``training/train_state.fused_flat_update`` ->
``ops/cuda/fused_adam.py`` -> ``csrc/fused_adam.cu``): kernel 3's percent
of its roofline in the training window: the bytes of every update (the
gradient, parameters, moments and EMA read, all but the gradient written)
at the HBM peak, against the kernel's time in the trace. Moves
``train_audio_rate``."""

from portbench import counters


def read(r: dict):
    tl = r.get("timeline")
    if r.get("kind") != "train" or tl is None or not r.get("adam_calls"):
        return None
    launches, seconds = tl.matching("fused_adam")
    if launches == 0:
        return None
    nbytes = sum(counters.fused_adam_bytes(n, mb, ema) for n, mb, ema in r["adam_calls"])
    return counters.kernel_share(0.0, nbytes, seconds, "f32")
