"""Dataset assembly and host->device loading.

Counterpart of ``neural_sound_generation_tpu/data/pipeline.py``: paired
raw-audio + mel sources over a train.txt manifest, length-bucketed
sampling, collation on IO worker threads behind a bounded queue, and
``device_prefetch``, which keeps batches on the device ahead of the step.
The batches are host numpy, equal to the JAX loader's for the same seed
and epoch. A loader assembles them either in C++ over mmap'd shards
(``data.native_loader``, the JAX package's native loader) or with the
Python collate, bit-equal either way; which one is decided once, when the
loader is made (``use_native``), and a native build or load failure
raises instead of falling back.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.data.collate import (
    as_model_batch,
    as_wave_batch,
    collate_mel_batch,
    static_crop_frames,
)
from neural_sound_generation_tpu_torch.data.native_loader import (
    NativeCorpus,
    load_library,
    native_available,
)
from neural_sound_generation_tpu_torch.data.sampler import (
    PartiallyRandomizedSimilarTimeLengthSampler,
    batched,
    shard_for_host,
)
from neural_sound_generation_tpu_torch.data.sources import NpyDataSource


class AudioDataset:
    """Paired (audio, mel, speaker) access (PyTorchDataset,
    dataloader.py:205-228)."""

    def __init__(self, x_source: NpyDataSource, mel_source: Optional[NpyDataSource]):
        self.X = x_source
        self.Mel = mel_source
        self.multi_speaker = x_source.multi_speaker

    def __len__(self):
        return len(self.X)

    def __getitem__(self, idx: int):
        speaker_id = self.X.speaker_ids[idx] if self.multi_speaker else None
        mel = self.Mel[idx] if self.Mel is not None else None
        return self.X[idx], mel, speaker_id


class MelFrameLoader:
    """Iterable of model-ready numpy batches with background prefetch.

    Each pass re-derives the sampler order from (seed, epoch); batches are
    collated to static shapes, host-sharded when running multi-host, and
    handed over through a bounded queue filled by IO worker threads."""

    def __init__(
        self,
        dataset: AudioDataset,
        cfg: Config,
        batch_size: int,
        num_hosts: int = 1,
        host_id: int = 0,
        num_workers: int = 4,
        seed: int = 1234,
        shuffle: bool = True,
        batch_mode: str = "mel",  # mel | wave | raw
        drop_last: bool = True,
        latent_stride: int = 4,
        use_native: Optional[bool] = None,
    ):
        if batch_mode not in ("mel", "wave", "raw"):
            raise ValueError(f"unknown batch_mode {batch_mode!r}")
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shuffle = shuffle
        self.batch_mode = batch_mode
        self.latent_stride = latent_stride
        self.drop_last = drop_last
        # the batch order of one pass is a pure function of (seed, _epoch):
        # __iter__ advances it, set_epoch pins it so a resumed run replays
        # the order an uninterrupted run would have seen
        self._epoch = 0
        # the native path (data/native_loader.py), decided here: None takes
        # it where g++ is on PATH and the corpus pairs mel shards, True
        # always, False never. Its library is built and loaded here (a
        # failure raises); its corpus, ``native``, is mapped at the first
        # pass, so that a bad shard fails the pass as it does on the
        # Python path
        if use_native is None:
            use_native = native_available() and dataset.Mel is not None
        if use_native and dataset.Mel is None:
            raise ValueError("the native loader needs paired mel shards")
        self.use_native = bool(use_native)
        self.native: Optional[NativeCorpus] = None
        if self.use_native:
            load_library()

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch for the NEXT pass (epoch ``e`` of a 1-based
        training loop is ``set_epoch(e - 1)``)."""
        self._epoch = int(epoch)

    def _open_native(self) -> NativeCorpus:
        if self.native is None:
            x, mel = self.dataset.X, self.dataset.Mel
            self.native = NativeCorpus([x.path(i) for i in range(len(x))],
                                       [mel.path(i) for i in range(len(x))])
        return self.native

    def _indices(self):
        if self.shuffle:
            sampler = PartiallyRandomizedSimilarTimeLengthSampler(
                self.dataset.X.lengths,
                batch_size=self.batch_size,
                seed=self.seed + self._epoch,
            )
            idx = list(iter(sampler))
        else:
            idx = list(range(len(self.dataset)))
        if self.num_hosts > 1:
            idx = shard_for_host(idx, self.num_hosts, self.host_id, self.batch_size)
        groups = batched(idx, self.batch_size, drop_last=self.drop_last)
        if not self.drop_last and groups and len(groups[-1]) < self.batch_size:
            # pad the final partial batch cyclically: shapes stay static
            last = groups[-1]
            n = len(last)
            for k in range(self.batch_size - n):
                last.append(last[k % n])
        return groups

    def __len__(self):
        n = len(self.dataset)
        if self.num_hosts > 1:
            n = len(shard_for_host(list(range(n)), self.num_hosts, self.host_id,
                                   self.batch_size))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _bucket_frames(self, batch_idx) -> Optional[int]:
        """Static frame count for this batch from DataConfig.bucket_boundaries:
        the smallest boundary >= the batch's longest utterance (clamped to
        the global crop)."""
        boundaries = self.cfg.data.bucket_boundaries
        if not boundaries:
            return None
        hop = self.cfg.audio.effective_hop_size
        cap = static_crop_frames(self.cfg.train.max_time_steps, hop, self.latent_stride)
        max_frames = max(self.dataset.X.lengths[i] // hop for i in batch_idx)
        for b in sorted(boundaries):
            if b % self.latent_stride == 0 and b >= max_frames:
                return min(b, cap)
        return cap

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        native = self._open_native() if self.use_native else None
        batches = self._indices()
        rng = np.random.default_rng(self.seed + 7919 * self._epoch)
        self._epoch += 1
        prefetch: "queue.Queue" = queue.Queue(maxsize=self.cfg.data.prefetch_depth)
        stop = object()
        abandoned = threading.Event()

        def safe_put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not abandoned.is_set():
                try:
                    prefetch.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def collate_native(batch_idx):
            gs = ([self.dataset.X.speaker_ids[i] for i in batch_idx]
                  if self.dataset.multi_speaker else None)
            return native.collate(
                batch_idx, self.cfg.audio, self.cfg.train.max_time_steps, rng,
                latent_stride=self.latent_stride, frames_out=self._bucket_frames(batch_idx),
                speaker_ids=gs,
                # mel-mode training reads only c (and g): no x/y fills
                need_audio=self.batch_mode != "mel")

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if native is not None:
                            out = collate_native(batch_idx)
                        else:
                            items = list(pool.map(self.dataset.__getitem__, batch_idx))
                            out = collate_mel_batch(
                                items,
                                self.cfg.audio,
                                self.cfg.train.max_time_steps,
                                rng,
                                latent_stride=self.latent_stride,
                                frames_out=self._bucket_frames(batch_idx),
                                one_hot=False,
                            )
                        if self.batch_mode == "mel":
                            out = as_model_batch(out)
                        elif self.batch_mode == "wave":
                            out = as_wave_batch(out, self.cfg.audio)
                        if not safe_put(out):
                            return
            except BaseException as e:  # noqa: BLE001 — surfaced in the consumer
                # a data error fails the epoch instead of ending it quietly
                safe_put(e)
                return
            safe_put(stop)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = prefetch.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            thread.join()
        finally:
            abandoned.set()


def get_audio_data_loaders(
    data_root: str,
    speaker_id: Optional[int],
    batch_size: int,
    cfg: Optional[Config] = None,
    test_shuffle: bool = True,
    num_hosts: int = 1,
    host_id: int = 0,
    batch_mode: str = "mel",
    latent_stride: int = 4,
) -> Dict[str, MelFrameLoader]:
    """Train/test loader pair over a preprocessed corpus directory
    (get_audio_data_loaders surface, dataloader.py:441-493)."""
    cfg = cfg or Config()
    loaders: Dict[str, MelFrameLoader] = {}
    for phase in ("train", "test"):
        train = phase == "train"
        sources = [
            NpyDataSource(
                data_root, col, speaker_id=speaker_id, train=train,
                test_size=cfg.data.test_size,
                test_num_samples=cfg.data.test_num_samples,
                random_state=cfg.data.random_state,
            )
            for col in ((0, 1) if cfg.arch.cin_channels > 0 else (0,))
        ]
        x_src = sources[0]
        dataset = AudioDataset(x_src, sources[1] if len(sources) > 1 else None)
        loaders[phase] = MelFrameLoader(
            dataset,
            cfg,
            batch_size,
            num_hosts=num_hosts,
            host_id=host_id,
            num_workers=cfg.data.num_workers,
            seed=cfg.data.random_state,
            shuffle=train or test_shuffle,
            batch_mode=batch_mode,
            drop_last=train,
            latent_stride=latent_stride,
        )
        if train and x_src.multi_speaker:
            hist = np.bincount(np.asarray(x_src.speaker_ids))
            print(f"Speaker stats: {dict(enumerate(hist.tolist()))}")
    return loaders


def device_prefetch(iterator, size: int = 2, device: torch.device | str = "cuda"):
    """Keep ``size`` batches on ``device`` ahead of consumption.

    Numpy arrays are copied into pinned host memory and sent with
    ``non_blocking`` copies on the current stream: the host's pinning and
    enqueue overlap the steps already queued on the card, while the copies
    themselves run in stream order, after the kernels enqueued before them
    and before the next step's. Tensors already on the device pass through.
    On the CPU the batches become tensors without copies."""
    device = torch.device(device)
    pin = device.type == "cuda"
    buf = collections.deque()

    def to_device(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        if t.device == device:
            return t
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def put(batch):
        buf.append({k: (None if v is None else to_device(v)) for k, v in batch.items()})

    it = iter(iterator)
    for batch in it:
        put(batch)
        if len(buf) >= max(1, size):
            break
    while buf:
        yield buf.popleft()
        for batch in it:
            put(batch)
            break
