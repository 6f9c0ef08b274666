"""Audio augmentation, profiling, codebook plots and a spectrogram dataset.

Counterpart of ``neural_sound_generation_tpu/utils/``, with the same
exports. ``augment`` is a copy (numpy and scipy); ``profiling`` traces
with ``torch.profiler``; ``spectrogram_dataset`` runs the port's STFT on a
device; ``visualize`` projects a codebook with the port's numpy PCA. The
JAX package's ``compilation_cache`` (XLA's persistent compilation cache)
has no counterpart: nothing here is compiled by XLA, and the port's CUDA
kernels are built once a digest by ``ops.cuda.build``.
"""

import importlib

from neural_sound_generation_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    trace_context,
)

#: the exports loaded at first use, so that importing ``utils.profiling``
#: (the training step's spans) loads neither scipy nor the plotting path
_LAZY = {
    "NoiseInjection": "augment",
    "augment_audio": "augment",
    "change_gain": "augment",
    "change_tempo": "augment",
    "project_codebook_2d": "visualize",
    "visualize_embedding": "visualize",
}
__all__ = ["StepTimer", "trace_context", *_LAZY]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
