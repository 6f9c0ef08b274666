"""Audio augmentation, profiling, codebook plots and a spectrogram dataset.

Counterpart of ``neural_sound_generation_tpu/utils/``, with the same
exports. ``augment`` is a copy (numpy and scipy); ``profiling`` traces
with ``torch.profiler``; ``spectrogram_dataset`` runs the port's STFT on a
device; ``visualize`` projects a codebook with the port's numpy PCA. The
JAX package's ``compilation_cache`` (XLA's persistent compilation cache)
has no counterpart: nothing here is compiled by XLA, and the port's CUDA
kernels are built once a digest by ``ops.cuda.build``.
"""

from neural_sound_generation_tpu_torch.utils.augment import (  # noqa: F401
    NoiseInjection,
    augment_audio,
    change_gain,
    change_tempo,
)
from neural_sound_generation_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    trace_context,
)
from neural_sound_generation_tpu_torch.utils.visualize import (  # noqa: F401
    project_codebook_2d,
    visualize_embedding,
)
