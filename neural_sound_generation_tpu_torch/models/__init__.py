from neural_sound_generation_tpu_torch.models.hiervqvae import HierVQVAE  # noqa: F401
from neural_sound_generation_tpu_torch.models.pixelcnn import GatedPixelCNN  # noqa: F401
from neural_sound_generation_tpu_torch.models.transformer_prior import (  # noqa: F401
    TransformerPrior,
)
from neural_sound_generation_tpu_torch.models.vae import VAE, DefaultVAE  # noqa: F401
from neural_sound_generation_tpu_torch.models.vqvae import (  # noqa: F401
    VQVAE,
    Decoder,
    Encoder,
)
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet  # noqa: F401
from neural_sound_generation_tpu_torch.models.wavevqvae import WaveVQVAE  # noqa: F401
