"""Corpus adapters and the batched preprocessing engine.

Counterpart of ``neural_sound_generation_tpu/data/corpora``: each adapter
collects a corpus's utterances in its own layout and runs them through
``engine.preprocess_utterances``."""

from neural_sound_generation_tpu_torch.data.corpora import (  # noqa: F401
    cmu_arctic,
    jsut,
    librivox,
    ljspeech,
)
from neural_sound_generation_tpu_torch.data.corpora.engine import (  # noqa: F401
    UtteranceSpec,
    preprocess_utterances,
)

CORPORA = {
    "ljspeech": ljspeech,
    "cmu_arctic": cmu_arctic,
    "jsut": jsut,
    "librivox": librivox,
}
