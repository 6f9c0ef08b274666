from neural_sound_generation_tpu_torch.models.vqvae import (  # noqa: F401
    VQVAE,
    Decoder,
    Encoder,
)
