"""Batch sampling: length-bucketed partial randomization + per-host sharding.

Rebuilds the semantics of ``PartialyRandomizedSimilarTimeLengthSampler``
(dataloader.py:158-202): sort by length, shuffle within fixed-size groups,
permute whole minibatches — minimizes pad waste while keeping randomness —
and the rank-slicing of ``DistributedBucketingSampler`` (util.py:353-391)
as a pure-function per-host shard.

A copy of ``neural_sound_generation_tpu/data/sampler.py`` (no JAX in it), kept
in the port so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence

import numpy as np


class PartiallyRandomizedSimilarTimeLengthSampler:
    """1. sort by length; 2. shuffle inside groups of batch_group_size;
    3. permute minibatches; 4. shuffle the tail remainder."""

    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int = 16,
        batch_group_size: Optional[int] = None,
        permutate: bool = True,
        seed: int = 1234,
    ):
        self.lengths = np.asarray(lengths)
        self.sorted_indices = np.argsort(self.lengths, kind="stable")
        self.batch_size = batch_size
        if batch_group_size is None:
            batch_group_size = min(batch_size * 32, len(self.lengths))
            if batch_group_size % batch_size != 0:
                batch_group_size -= batch_group_size % batch_size
        self.batch_group_size = max(batch_group_size, 1)
        assert self.batch_group_size % batch_size == 0 or (
            self.batch_group_size < batch_size
        )
        self.permutate = permutate
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        indices = self.sorted_indices.copy()
        g = self.batch_group_size
        e = 0
        for i in range(len(indices) // g):
            s, e = i * g, (i + 1) * g
            self._rng.shuffle(indices[s:e])
        if self.permutate and e > 0:
            full = indices[: (e // self.batch_size) * self.batch_size]
            batches = full.reshape(-1, self.batch_size)
            perm = self._rng.permutation(len(batches))
            indices[: len(full)] = batches[perm].reshape(-1)
        if e < len(indices):
            tail = indices[e:]
            self._rng.shuffle(tail)
            indices[e:] = tail
        return iter(indices.tolist())

    def __len__(self) -> int:
        return len(self.sorted_indices)


def _pad_to_multiple(seq: list, m: int) -> list:
    """Cyclically extend ``seq`` to a multiple of ``m`` items."""
    r = len(seq) % m
    if m <= 1 or not seq or r == 0:
        return seq
    return seq + list(itertools.islice(itertools.cycle(seq), m - r))


def shard_for_host(
    indices: Sequence[int], num_hosts: int, host_id: int, batch_size: int = 1
) -> List[int]:
    """Deterministic per-host slice: host h takes every num_hosts-th batch
    starting at h (the DistributedBucketingSampler rank semantics,
    util.py:374-381). With batch_size=1 this is element-wise striding.

    Like the reference sampler (util.py:383-386), the stream is padded
    cyclically to a multiple of ``num_hosts`` first so EVERY host gets
    the same count: per-step pjit collectives are cross-host barriers,
    and a host with one extra batch would hang the pod at epoch end
    waiting for peers that already finished."""
    indices = list(indices)
    if batch_size > 1:
        batches = [
            indices[i : i + batch_size]
            for i in range(0, len(indices) - batch_size + 1, batch_size)
        ]
        mine = _pad_to_multiple(batches, num_hosts)[host_id::num_hosts]
        return [i for b in mine for i in b]
    return _pad_to_multiple(indices, num_hosts)[host_id::num_hosts]


def batched(indices: Sequence[int], batch_size: int, drop_last: bool = True):
    """Group an index stream into fixed-size batches (static XLA shapes)."""
    out, cur = [], []
    for i in indices:
        cur.append(i)
        if len(cur) == batch_size:
            out.append(cur)
            cur = []
    if cur and not drop_last:
        out.append(cur)
    return out
