"""Tacotron-2 configuration surface.

A copy of ``neural_sound_generation_tpu/config/tacotron.py``. The
reference carries a full Tacotron-2 hyperparameter bag
(``src/hparams_tacotron.py:120-167``: encoder convs + BiLSTM,
location-sensitive attention, prenet/decoder LSTMs, residual postnet,
CBHG mel->linear network) with **no engine anywhere in the repo** —
config only, consumed solely for its audio block (SURVEY §2 row 12).
This dataclass preserves that configuration surface (same field names and
defaults) so existing setups translate; the synthesis engine remains
out of scope, exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TacotronArchConfig:
    # global
    outputs_per_step: int = 1
    stop_at_any: bool = True
    embedding_dim: int = 512
    # encoder
    enc_conv_num_layers: int = 3
    enc_conv_kernel_size: Tuple[int, ...] = (5,)
    enc_conv_channels: int = 512
    encoder_lstm_units: int = 256
    # attention
    smoothing: bool = False
    attention_dim: int = 128
    attention_filters: int = 32
    attention_kernel: Tuple[int, ...] = (31,)
    cumulative_weights: bool = True
    # decoder
    prenet_layers: Sequence[int] = (256, 256)
    decoder_layers: int = 2
    decoder_lstm_units: int = 1024
    max_iters: int = 2000
    # residual postnet
    postnet_num_layers: int = 5
    postnet_kernel_size: Tuple[int, ...] = (5,)
    postnet_channels: int = 512
    # CBHG mel->linear
    cbhg_kernels: int = 8
    cbhg_conv_channels: int = 128
    cbhg_pool_size: int = 2
    cbhg_projection: int = 256
    cbhg_projection_kernel_size: int = 3
    cbhg_highwaynet_layers: int = 4
    cbhg_highway_units: int = 128
    cbhg_rnn_units: int = 128
    # loss
    mask_encoder: bool = True
    mask_decoder: bool = False
    cross_entropy_pos_weight: int = 20
    predict_linear: bool = True
    # multi-device knobs (config only in the reference too,
    # hparams_tacotron.py:37-41)
    tacotron_num_gpus: int = 1
    wavenet_num_gpus: int = 1
    split_on_cpu: bool = True
