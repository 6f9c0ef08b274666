from neural_sound_generation_tpu_torch.config.hparams import (  # noqa: F401
    AudioConfig,
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    VocoderArchConfig,
    config_debug_string,
    load_preset,
)
from neural_sound_generation_tpu_torch.config.tacotron import (  # noqa: F401
    TacotronArchConfig,
)
