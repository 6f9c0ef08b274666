from neural_sound_generation_tpu_torch.inference.audio import (  # noqa: F401
    codes_to_audio,
    extract_units,
    hier_cond_map,
    prior_generate,
    reconstruct_audio,
    sample_hier_audio,
    sample_hier_mels,
    sample_prior_audio,
    sample_prior_mels,
)
