"""Unified typed configuration.

The reference keeps two divergent ``tf.contrib.training.HParams`` bags live
simultaneously (``src/hparams.py:8-129`` for the "vocoder" pipeline and
``src/hparams_tacotron.py:5-390`` for the LJSpeech/main path — they even
disagree on ``num_mels``: 80 vs 40) plus frozen JSON presets overlaid via
``hparams.parse_json`` (``src/preprocess.py:62-64``).

Here that collapses into one frozen-dataclass tree with a JSON preset
overlay that accepts the reference preset schema (``src/presets/*.json``)
unchanged: every key of those files maps onto a field below, so existing
preset files keep working.

A copy of ``neural_sound_generation_tpu/config/hparams.py`` (no JAX in it),
kept in the port so that the port imports nothing of the JAX package. The
training fields are carried for preset compatibility; the port's serving
path reads the audio, arch and model sections.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


def _replace(dc, **kw):
    return dataclasses.replace(dc, **kw) if kw else dc


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """DSP parameters for the mel/linear spectrogram transform chain.

    Semantics follow the reference chain (``src/audio_tacotron.py``):
    preemphasis -> STFT -> mel -> amp_to_db -> normalize, with mu-law
    encode/quantize variants and Griffin-Lim inversion.
    """

    sample_rate: int = 22050
    fft_size: int = 1024
    hop_size: int = 256
    win_size: int | None = None  # None -> fft_size
    frame_shift_ms: float | None = None  # alternative to hop_size
    num_mels: int = 80
    fmin: float = 125.0
    fmax: float = 7600.0
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    # preemphasis filter (audio_tacotron.py:23-31)
    preemphasize: bool = True
    preemphasis: float = 0.97
    # normalization variants (audio_tacotron.py:228-254)
    signal_normalization: bool = True
    allow_clipping_in_normalization: bool = True
    symmetric_mels: bool = False
    max_abs_value: float = 1.0
    # Griffin-Lim (audio_tacotron.py:142-152); power applied pre-inversion
    power: float = 1.5
    griffin_lim_iters: int = 60
    # fast Griffin-Lim momentum (0 = plain reference algorithm); 0.99
    # typically halves the iterations needed
    griffin_lim_momentum: float = 0.0
    # LWS STFT convention + phase estimation (ops/lws.py). The reference's
    # wavenet-variant chain (audio.py, cmu_arctic/jsut/librivox) is
    # LWS-only; its tacotron variant gates on use_lws
    # (audio_tacotron.py:89,155, hparams_tacotron.py:77 default False)
    use_lws: bool = False
    lws_iterations: int = 100
    lws_k_radius: int = 2  # lws's L = 2*k_radius + 1 (speech mode L=5)
    # waveform input encoding (hparams.py:23-24)
    input_type: str = "raw"  # raw | mulaw | mulaw-quantize
    quantize_channels: int = 65536
    silence_threshold: int = 2
    # peak rescaling (hparams.py:42-43)
    rescaling: bool = True
    rescaling_max: float = 0.999
    # silence trimming (hparams_tacotron trim block)
    trim_silence: bool = True
    trim_fft_size: int = 512
    trim_hop_size: int = 128
    trim_top_db: float = 23.0

    def __post_init__(self):
        if self.input_type not in ("raw", "mulaw", "mulaw-quantize"):
            raise ValueError(f"invalid input_type: {self.input_type!r}")
        if self.fmax > self.sample_rate // 2:
            raise ValueError(
                f"fmax={self.fmax} exceeds Nyquist for sr={self.sample_rate}"
            )

    @property
    def effective_hop_size(self) -> int:
        """hop_size, or derived from frame_shift_ms (audio_tacotron.py:54-60)."""
        if self.hop_size is not None:
            return self.hop_size
        assert self.frame_shift_ms is not None
        return int(self.frame_shift_ms / 1000 * self.sample_rate)

    @property
    def effective_win_size(self) -> int:
        return self.win_size if self.win_size is not None else self.fft_size

    @property
    def is_mulaw_quantize(self) -> bool:
        return self.input_type == "mulaw-quantize"

    @property
    def is_mulaw(self) -> bool:
        return self.input_type == "mulaw"

    @property
    def is_raw(self) -> bool:
        return self.input_type == "raw"

    @property
    def is_scalar_input(self) -> bool:
        return self.is_raw or self.is_mulaw


@dataclasses.dataclass(frozen=True)
class VocoderArchConfig:
    """WaveNet-style architecture surface carried by the reference presets.

    Mirrors the keys of ``src/hparams.py:52-84`` so that the reference
    preset JSONs (e.g. ``src/presets/ljspeech_mixture.json``) round-trip.
    Only ``cin_channels``/``gin_channels``/``n_speakers`` influence the
    VQ-VAE data path; the rest is kept for schema compatibility and for the
    (optional) wavenet decoder family.
    """

    builder: str = "wavenet"
    out_channels: int = 30
    layers: int = 24
    stacks: int = 4
    residual_channels: int = 512
    gate_channels: int = 512
    skip_out_channels: int = 256
    dropout: float = 0.05
    kernel_size: int = 3
    weight_normalization: bool = True
    legacy: bool = True
    log_scale_min: float = -32.23619130191664
    cin_channels: int = 80
    upsample_conditional_features: bool = True
    upsample_scales: tuple = (4, 4, 4, 4)
    freq_axis_kernel_size: int = 3
    gin_channels: int = -1
    n_speakers: int = 7


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Loader/split parameters (hparams.py:86-94, dataloader.py)."""

    pin_memory: bool = True
    num_workers: int = 2
    test_size: float | None = 0.0441
    test_num_samples: int | None = None
    random_state: int = 1234
    # static-shape batching for XLA: bucket boundaries in mel frames
    bucket_boundaries: tuple = ()
    prefetch_depth: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Autoencoder family (models.py:64-341)."""

    model: str = "vqvae"  # vae | vqvae | wavevqvae | hiervqvae
    input_dim: int = 1
    dim: int = 256
    z_dim: int = 512  # codebook size for vqvae, latent channels for vae
    beta: float = 1.0  # commitment weight (main.py:49-51)
    # residual VQ stages (SoundStream-style); 1 = single codebook
    num_quantizers: int = 1
    # wavevqvae only: stride-2 encoder layers — the unit rate is
    # sr / 2^num_downsample (6 -> 64x, the ZeroSpeech-style 250 Hz at
    # 16 kHz; 4 -> 16x trades unit rate for waveform fidelity)
    num_downsample: int = 6
    # EMA codebook updates (VQ-VAE v2 style) as a config switch; the
    # reference uses gradient-descent codebook learning only.
    ema_codebook: bool = False
    ema_codebook_decay: float = 0.99
    # reinitialize codes whose EMA cluster size falls below this from
    # random encoder outputs (0 disables); fights codebook collapse
    restart_dead_threshold: float = 0.0
    # PixelCNN prior (models.py:285-341)
    prior_layers: int = 15
    prior_dim: int = 64
    prior_n_classes: int = 10

    def __post_init__(self):
        if self.model not in ("vae", "vqvae", "wavevqvae", "hiervqvae"):
            raise ValueError(f"invalid model: {self.model!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization/training loop parameters (hparams.py:98-126, main.py:25-58)."""

    batch_size: int = 2
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    amsgrad: bool = False
    initial_learning_rate: float = 1e-3
    lr_schedule: str = "noam_learning_rate_decay"
    lr_schedule_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    nepochs: int = 2000
    weight_decay: float = 0.0
    clip_thresh: float = -1.0
    max_time_sec: float | None = None
    max_time_steps: int | None = 8000
    exponential_moving_average: bool = True
    ema_decay: float = 0.9999
    # Opt-in deviation from the reference's fixed-decay EMA
    # (src/dataloader.py:246-257: averaged = decay*averaged + (1-decay)*x):
    # tf.train.ExponentialMovingAverage-style warmup min(decay, (1+t)/(10+t)),
    # which keeps short runs from evaluating near-init shadow weights.
    ema_warmup: bool = False
    checkpoint_interval: int = 10000
    train_eval_interval: int = 10000
    test_eval_epoch_interval: int = 5
    save_optimizer_state: bool = True
    seed: int = 1
    log_interval: int = 10
    # Flat fused Adam+EMA update (one fusion over ravel_pytree instead of
    # one per leaf — measured win on TPU, PERF.md). Checkpoints are not
    # interchangeable across values of this flag (optimizer-state layout
    # differs). Disable for tensor-parallel param shardings.
    fused_optimizer: bool = True
    # Store the fused optimizer's Adam moments (m, v) in bfloat16. The
    # fused update is HBM-bandwidth-bound (PERF.md step attribution), so
    # halving the moment bytes trims the optimizer stage; the update math
    # still runs in f32 (moments are upcast, computed, and rounded back).
    # Params and the EMA shadow stay f32. Opt-in; fused path only.
    bf16_moments: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level configuration: the single namespace replacing the
    reference's three hparams modules + argparse surface."""

    name: str = "vocoder"
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    arch: VocoderArchConfig = dataclasses.field(default_factory=VocoderArchConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    # ---- reference-preset-schema overlay -------------------------------

    # flat reference key -> (section, field)
    _PRESET_KEYMAP = None  # class attr set below

    @classmethod
    def preset_keymap(cls) -> Mapping[str, tuple]:
        """Map every key of the reference preset JSON schema
        (src/presets/*.json; src/hparams.py:8-129) to a (section, field)."""
        m: dict[str, tuple] = {}
        audio_keys = [
            "sample_rate", "fft_size", "hop_size", "frame_shift_ms",
            "num_mels", "fmin", "fmax", "min_level_db", "ref_level_db",
            "input_type", "quantize_channels", "silence_threshold",
            "rescaling", "rescaling_max", "allow_clipping_in_normalization",
            "preemphasize", "preemphasis", "signal_normalization",
            "symmetric_mels", "max_abs_value", "power", "griffin_lim_iters",
            "griffin_lim_momentum",
            "trim_silence", "trim_fft_size", "trim_hop_size", "trim_top_db",
            "win_size",
            "use_lws", "lws_iterations", "lws_k_radius",
        ]
        arch_keys = [
            "builder", "out_channels", "layers", "stacks",
            "residual_channels", "gate_channels", "skip_out_channels",
            "dropout", "kernel_size", "weight_normalization", "legacy",
            "log_scale_min", "cin_channels", "upsample_conditional_features",
            "upsample_scales", "freq_axis_kernel_size", "gin_channels",
            "n_speakers",
        ]
        data_keys = [
            "pin_memory", "num_workers", "test_size", "test_num_samples",
            "random_state",
        ]
        train_keys = [
            "batch_size", "adam_beta1", "adam_beta2", "adam_eps", "amsgrad",
            "initial_learning_rate", "lr_schedule", "lr_schedule_kwargs",
            "nepochs", "weight_decay", "clip_thresh", "max_time_sec",
            "max_time_steps", "exponential_moving_average", "ema_decay",
            "checkpoint_interval", "train_eval_interval",
            "test_eval_epoch_interval", "save_optimizer_state",
        ]
        for k in audio_keys:
            m[k] = ("audio", k)
        for k in arch_keys:
            m[k] = ("arch", k)
        for k in data_keys:
            m[k] = ("data", k)
        for k in train_keys:
            m[k] = ("train", k)
        return m

    def parse_json(self, text_or_mapping: str | Mapping[str, Any]) -> "Config":
        """Overlay a flat reference-schema JSON preset onto this config.

        Equivalent surface to ``hparams.parse_json`` as used in
        ``src/preprocess.py:62-64``. Unknown keys raise (matching HParams
        strictness). Returns a new frozen Config.
        """
        if isinstance(text_or_mapping, str):
            flat = json.loads(text_or_mapping)
        else:
            flat = dict(text_or_mapping)
        keymap = self.preset_keymap()
        updates: dict[str, dict[str, Any]] = {}
        name = self.name
        for key, value in flat.items():
            if key == "name":
                name = value
                continue
            if key not in keymap:
                raise KeyError(f"unknown preset key: {key!r}")
            section, field = keymap[key]
            if isinstance(value, list):
                value = tuple(value)
            updates.setdefault(section, {})[field] = value
        return Config(
            name=name,
            audio=_replace(self.audio, **updates.get("audio", {})),
            arch=_replace(self.arch, **updates.get("arch", {})),
            data=_replace(self.data, **updates.get("data", {})),
            model=self.model,
            train=_replace(self.train, **updates.get("train", {})),
        )

    def parse(self, overrides: str) -> "Config":
        """Comma-separated ``key=value`` overrides (HParams.parse surface,
        used by ``preprocess.py --hparams``). Commas inside brackets or
        quotes belong to the value — ``upsample_scales=[4,4,4,4],fmin=0``
        is two overrides, like tf.HParams list parsing."""
        if not overrides:
            return self
        flat: dict[str, Any] = {}
        for item in _split_overrides(overrides):
            if not item.strip():
                continue
            key, _, raw = item.partition("=")
            key = key.strip()
            raw = raw.strip()
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            flat[key] = value
        return self.parse_json(flat)

    def to_flat_dict(self) -> dict[str, Any]:
        """Inverse of parse_json: flat reference-schema dict."""
        out: dict[str, Any] = {"name": self.name}
        for key, (section, field) in self.preset_keymap().items():
            value = getattr(getattr(self, section), field)
            if isinstance(value, tuple):
                value = list(value)
            out[key] = value
        return out


def _split_overrides(s: str) -> list:
    """Split ``key=value`` overrides on TOP-LEVEL commas only: commas
    nested in []/{}/() or inside quotes are part of a JSON value."""
    items, buf = [], []
    depth = 0
    quote = None
    for ch in s:
        if quote is not None:
            buf.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            buf.append(ch)
        elif ch in "[{(":
            depth += 1
            buf.append(ch)
        elif ch in "]})":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            items.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        items.append("".join(buf))
    return items


def load_preset(path: str, base: Config | None = None) -> Config:
    """Load a preset JSON file (reference schema) over a base config."""
    base = base or Config()
    with open(path, "r", encoding="utf-8") as f:
        return base.parse_json(f.read())


def config_debug_string(cfg: Config) -> str:
    """Sorted key: value dump (hparams_debug_string, src/hparams.py:132-135)."""
    flat = cfg.to_flat_dict()
    lines = ["  %s: %s" % (k, flat[k]) for k in sorted(flat)]
    return "Hyperparameters:\n" + "\n".join(lines)
