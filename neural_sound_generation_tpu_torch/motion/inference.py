"""Motion-conditioned sound generation.

Counterpart of ``neural_sound_generation_tpu/motion/inference.py``: a native
``MotionController`` streams joint-angle frames, a ``PCAProjector`` reduces
them on the host (float64), and a feature-conditioned VQ-VAE
(``VQVAE.decode_from_features``) renders mel frames on the device, one
nearest-code search of B * H' * W' rows a call; ``frames_to_audio`` inverts
them by Griffin-Lim on the device.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.motion.capture import MotionController
from neural_sound_generation_tpu_torch.motion.pca import PCAProjector
from neural_sound_generation_tpu_torch.ops import dsp


class MotionDrivenGenerator:
    """latents (B, n_components) -> mel frames -> audio, batched on the
    device. The model is moved to ``resolve_device(device)`` (the card
    unless the caller names another) and put in eval mode."""

    def __init__(
        self,
        model: VQVAE,
        projector: PCAProjector,
        cfg: AudioConfig,
        latent_hw: Tuple[int, int] = (20, 8),
        device: str | torch.device | None = None,
    ):
        assert model.cond_features == projector.n_components, (
            f"model expects {model.cond_features} conditioning features, "
            f"projector provides {projector.n_components}"
        )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.projector = projector
        self.cfg = cfg
        self.latent_hw = tuple(latent_hw)

    @torch.no_grad()
    def _decode(self, latents: np.ndarray) -> torch.Tensor:
        """(B, n_components) latents, cast to float32 -> (B, num_mels,
        frames) on the device."""
        x = torch.from_numpy(np.ascontiguousarray(latents, np.float32)).to(self.device)
        return self.model.decode_from_features(x, self.latent_hw)[..., 0]

    def frames_to_mel(self, feature_frames: np.ndarray) -> torch.Tensor:
        """Joint-angle frames (B, 18) -> mel batch (B, num_mels, frames)."""
        return self._decode(self.projector.project(feature_frames))

    def frames_to_audio(
        self,
        feature_frames: np.ndarray,
        generator: torch.Generator | None = None,
        init_angles: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """(B, 18) frames -> (B, samples) by Griffin-Lim, its initial phase
        drawn from ``generator`` or given as ``init_angles``."""
        mel = self.frames_to_mel(feature_frames)
        return dsp.inv_mel_spectrogram_batch(mel, self.cfg, generator, init_angles)

    def run_stream(
        self,
        controller: MotionController,
        window: int = 16,
        max_windows: Optional[int] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Consume a controller synchronously in windows of ``window``
        frames, yielding (latents, mel) per window, the mel (num_mels,
        frames) on the host. Each window's projected latents are mean-pooled
        into one conditioning vector producing one mel window, so
        consecutive windows form a continuous mel stream."""
        produced = 0
        while max_windows is None or produced < max_windows:
            frames = controller.drain(window)
            if len(frames) == 0:
                break
            latents = self.projector.project(frames)
            pooled = latents.mean(axis=0, keepdims=True)  # (1, n_components)
            mel = self._decode(pooled).cpu().numpy()
            yield latents, mel[0]
            produced += 1
