from neural_sound_generation_tpu_torch.models.transformer_prior import (  # noqa: F401
    TransformerPrior,
)
from neural_sound_generation_tpu_torch.models.vqvae import (  # noqa: F401
    VQVAE,
    Decoder,
    Encoder,
)
