from neural_sound_generation_tpu_torch.inference.audio import (  # noqa: F401
    codes_to_audio,
    extract_units,
    reconstruct_audio,
    sample_prior_audio,
    sample_prior_mels,
)
