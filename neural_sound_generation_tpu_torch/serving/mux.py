"""WaveNet stream multiplexer: up to S concurrent streams, one chunk loop.

Counterpart of ``neural_sound_generation_tpu/serving/mux.py``. A fixed batch
of S slots steps through ``make_chunked_generate_fn``'s ``step_chunk`` on one
worker thread: live sessions occupy slots, idle slots carry zeros, a joining
stream waits at most one chunk boundary for its first samples, and a
finishing stream frees its slot for the next caller.

- Each session's upsampled conditioning is padded into a fixed (S, L_max,
  C) slot buffer on the model's device; each loop iteration slices every
  slot's chunk at its own offset and runs one batched chunk.
- A freshly joined slot's generation state (its ring and previous sample)
  is zeroed before its first chunk.
- Each chunk is copied to the host and delivered as soon as it is computed.
  (The JAX multiplexer dispatches chunk k+1 before it delivers chunk k,
  which overlaps the two under asynchronous dispatch; eager PyTorch
  computes a chunk while it enqueues it, so holding chunk k back would only
  delay it by a chunk.)
- Noise is drawn per (session seed, chunk ordinal) from a ``torch.Generator``
  seeded with a hash of the two, in ``draw_noise``'s layout, so a session's
  audio is deterministic, independent of the other slots and of which slot
  it lands in. As in the JAX package, it is not bit-equal to the solo
  streaming sampler with the same seed, which draws the whole length's
  noise at once.
"""

from __future__ import annotations

import hashlib
import queue
import threading
from typing import Optional

import numpy as np
import torch

from neural_sound_generation_tpu_torch.models.wavenet import (
    WaveNet,
    _upsample_cond,
    draw_noise,
    make_chunked_generate_fn,
)


class MuxOverloaded(RuntimeError):
    """Raised by ``open`` when the pending queue is at ``max_pending``."""


def chunk_seed(seed: int, ordinal: int) -> int:
    """The noise seed of one session's chunk: a hash of (seed, ordinal), so
    neighbouring seeds and ordinals give unrelated streams."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(ordinal)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class _Session:
    __slots__ = ("length", "pos", "slot", "seed", "queue", "c_up", "cancelled")

    def __init__(self, c_up: torch.Tensor, length: int, seed: int):
        self.c_up = c_up  # (L_max, C) padded, until placed in a slot
        self.length = length
        self.pos = 0
        self.slot: Optional[int] = None
        self.seed = seed
        self.queue: queue.Queue = queue.Queue()
        self.cancelled = False


class _StreamHandle:
    """Chunk iterator for one session, with a ``close()`` that always
    cancels: the session is admitted by ``open()`` before any iteration, so
    a generator's ``close()`` (which skips an unstarted generator's
    ``finally``) would leave an abandoned session synthesizing into a queue
    nothing drains."""

    def __init__(self, mux: "WaveNetStreamMux", sess: _Session):
        self._mux = mux
        self._sess = sess

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        item = self._sess.queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._mux._cancel(self._sess)

    def __del__(self):  # a dropped handle cancels too
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown  # pragma: no cover
            pass


class WaveNetStreamMux:
    """Multiplex up to ``slots`` concurrent generation streams.

    ``open(c, seed)`` -> iterator of (<= chunk,) numpy pieces (float32
    samples, or int64 sample ids for a categorical model) for a (T', cin_channels) mel (not upsampled: the solo streaming
    sampler's input). While every slot is busy new sessions queue and are
    admitted at the next free chunk boundary; ``max_pending`` bounds that
    queue (``open`` raises ``MuxOverloaded`` once ``max_pending`` sessions
    are waiting beyond the free slots, so a server can answer 503).
    ``max_seconds`` bounds one utterance (the slot buffer's capacity);
    longer conditioning raises ValueError."""

    def __init__(self, model: WaveNet, chunk: int = 4096, slots: int = 8,
                 dtype=torch.bfloat16, max_seconds: float = 10.0, sample_rate: int = 22050,
                 max_pending: Optional[int] = None):
        if not model.conditioned:
            raise ValueError("the stream mux needs local conditioning")
        self.model = model
        self.chunk = int(chunk)
        self.slots = int(slots)
        self.max_pending = None if max_pending is None else int(max_pending)
        # ceil: an utterance within max_seconds must fit
        n_chunks_cap = max(1, -(-int(max_seconds * sample_rate) // self.chunk))
        self.l_max = n_chunks_cap * self.chunk
        self._device = model.first_conv.weight.device
        init_state, self._step_chunk, _ = make_chunked_generate_fn(model, self.chunk, dtype)
        self._state = init_state(self.slots)
        self._c_slots = torch.zeros(self.slots, self.l_max, model.cin_channels,
                                    dtype=dtype or torch.float32, device=self._device)
        self._n_noise = model.out_channels // 3 if model.scalar_input else model.out_channels
        self._seeds = [0] * self.slots
        self._pos = [0] * self.slots
        self._sessions: list = [None] * self.slots
        self._pending: list = []
        self._busy = False  # the worker is inside a chunk
        self._cv = threading.Condition()
        self._started = False

    # ------------------------------------------------------------- public

    def open(self, c, seed: int) -> _StreamHandle:
        """(T', cin_channels) mel + seed -> chunk iterator. Upsamples on
        the model's device, pads into a slot-capacity buffer and queues the
        session; the worker gives it a slot at the next chunk boundary."""
        seed = int(seed)
        c = torch.as_tensor(c, dtype=torch.float32, device=self._device)
        if c.ndim != 2 or c.shape[1] != self.model.cin_channels:
            raise ValueError(f"conditioning must be (frames, {self.model.cin_channels}), "
                             f"got {tuple(c.shape)}")
        # shed before the device work: rejected requests must not spend it;
        # the check that counts runs again under the lock at append time
        if self.max_pending is not None:
            with self._cv:
                self._raise_if_overloaded()
        with torch.no_grad():
            c_up = _upsample_cond(self.model, c[None])[0]
        length = int(c_up.shape[0])
        if length > self.l_max:
            raise ValueError(
                f"utterance of {length} samples exceeds the mux slot capacity "
                f"{self.l_max}; raise max_seconds"
            )
        padded = torch.zeros(self.l_max, c_up.shape[1], dtype=self._c_slots.dtype,
                             device=self._device)
        padded[:length] = c_up
        sess = _Session(padded, length, seed)
        with self._cv:
            if self.max_pending is not None:
                self._raise_if_overloaded()
            if not self._started:
                threading.Thread(target=self._worker, daemon=True,
                                 name="nsg-streammux").start()
                self._started = True
            self._pending.append(sess)
            self._cv.notify_all()
        return _StreamHandle(self, sess)

    @property
    def active(self) -> int:
        with self._cv:
            return sum(s is not None for s in self._sessions)

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def busy(self) -> bool:
        """Whether the worker is computing or delivering a chunk (a
        cancelled session has left its slot by then)."""
        with self._cv:
            return self._busy

    # ------------------------------------------------------------ private

    def _raise_if_overloaded(self) -> None:
        """The backlog is the queued sessions the free slots will not absorb
        at the next chunk boundary; a free slot always admits (max_pending=0
        means slots only). Called under the lock."""
        free = sum(s is None for s in self._sessions)
        backlog = len(self._pending) - free
        if backlog >= self.max_pending:
            raise MuxOverloaded(
                f"{len(self._pending)} sessions waiting for {free} free slots "
                f"(max_pending={self.max_pending}); retry later"
            )

    def _cancel(self, sess: _Session) -> None:
        """Free a session's slot or queue entry at the next chunk boundary
        and drop its buffered chunks. Idempotent; safe after completion."""
        with self._cv:
            sess.cancelled = True
            if sess in self._pending:
                self._pending.remove(sess)
            elif sess.slot is not None and self._sessions[sess.slot] is sess:
                self._sessions[sess.slot] = None
        # a racing delivery after this is bounded by the chunk in flight
        # (the worker checks `cancelled` before it delivers)
        try:
            while True:
                sess.queue.get_nowait()
        except queue.Empty:
            pass

    def _assign_pending_locked(self) -> None:
        prev, ring = self._state
        for slot in range(self.slots):
            if self._sessions[slot] is None and self._pending:
                sess = self._pending.pop(0)
                sess.slot = slot
                self._sessions[slot] = sess
                self._c_slots[slot] = sess.c_up
                sess.c_up = None  # placed; free the staging buffer
                self._seeds[slot] = sess.seed
                self._pos[slot] = 0
                # a fresh slot starts from zero state, whatever ran there
                ring[:, slot] = 0
                prev[slot] = 0

    def _noise(self, active: list) -> tuple[torch.Tensor, torch.Tensor]:
        """(chunk, S, n) gumbel and (chunk, S) uniform: each live slot's
        from its (seed, chunk ordinal); idle slots get zeros and 0.5."""
        gum = torch.zeros(self.chunk, self.slots, self._n_noise, device=self._device)
        unif = torch.full((self.chunk, self.slots), 0.5, device=self._device)
        for slot, _ in active:
            gen = torch.Generator(device=self._device).manual_seed(
                chunk_seed(self._seeds[slot], self._pos[slot] // self.chunk))
            g, u = draw_noise(self.model, gen, self.chunk, 1)
            gum[:, slot], unif[:, slot] = g[:, 0], u[:, 0]
        return gum, unif

    def _dispatch(self, active: list) -> torch.Tensor:
        c_chunk = torch.stack([self._c_slots[s, p : p + self.chunk]
                               for s, p in enumerate(self._pos)])
        gum, unif = self._noise(active)
        self._state, out = self._step_chunk(self._state, c_chunk, gum, unif, None)
        return out

    def _worker(self) -> None:
        try:
            self._loop()
        except Exception as e:  # noqa: BLE001 — wake every caller
            with self._cv:
                victims = [s for s in self._sessions if s is not None]
                victims += self._pending
                self._sessions = [None] * self.slots
                self._pending = []
                self._busy = False
                self._started = False
            for s in victims:
                s.queue.put(e)

    def _loop(self) -> None:
        while True:
            with self._cv:
                self._busy = False
                self._assign_pending_locked()
                active = [(slot, s) for slot, s in enumerate(self._sessions) if s is not None]
                if not active:
                    self._cv.wait()
                    continue
                self._busy = True
            arr = self._dispatch(active).cpu().numpy()
            # a session leaves its slot only once its last chunk is on the
            # host, so a failure before this point wakes it in _worker
            for slot, s in active:
                valid = min(self.chunk, s.length - s.pos)
                s.pos += self.chunk
                final = s.pos >= s.length
                if final:
                    with self._cv:
                        self._sessions[slot] = None
                else:
                    self._pos[slot] = s.pos
                if s.cancelled:
                    continue  # consumer gone; do not grow its queue
                s.queue.put(arr[slot, :valid].copy())
                if final:
                    s.queue.put(None)
