from neural_sound_generation_tpu_torch.inference.audio import (  # noqa: F401
    sample_prior_audio,
    sample_prior_mels,
)
