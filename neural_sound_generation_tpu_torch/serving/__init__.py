"""Serving primitives: the WaveNet stream multiplexer."""

from neural_sound_generation_tpu_torch.serving.mux import MuxOverloaded, WaveNetStreamMux

__all__ = ["MuxOverloaded", "WaveNetStreamMux"]
