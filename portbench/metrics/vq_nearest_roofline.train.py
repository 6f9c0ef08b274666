"""VQ (``ops/vq.py`` -> ``ops/cuda/vq_kernel.py`` -> ``csrc/vq_nearest.cu``):
kernel 1's percent of its roofline in the training window, 2NKD operations
at the TF32 tensor-core peak and its bytes at the HBM peak, against the
kernel's time in the trace. Moves ``train_audio_rate``."""

from portbench.metrics._common import vq_nearest_share


def read(r: dict):
    return vq_nearest_share(r) if r.get("kind") == "train" else None
