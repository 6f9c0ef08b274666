"""Model and autograd (``models/``, cuDNN, kernels 1 and 3): the device
milliseconds of a training step, the sum of every device operation's time
in the window's trace over the steps. Moves ``train_audio_rate``."""


def read(r: dict):
    tl = r.get("timeline")
    if r.get("kind") != "train" or tl is None or not r.get("steps"):
        return None
    return 1e3 * tl.kernel_seconds() / r["steps"]
