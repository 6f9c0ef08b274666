"""Tracing and per-step timing.

Counterpart of ``neural_sound_generation_tpu/utils/profiling.py``:
``trace_context`` wraps a block in a named ``torch.profiler`` range and,
with a ``logdir``, writes a ``torch.profiler`` trace of it there (CPU
activity, and the card's where CUDA is available), readable by
TensorBoard's profiler plugin or as Chrome trace JSON; ``StepTimer``
aggregates blocked per-step wall times with percentile summaries.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_context(logdir: Optional[str] = None, name: str = "train"):
    """Profile the enclosed block. With ``logdir``, records a full
    ``torch.profiler`` trace and writes it there on exit; always annotates
    the block with ``record_function(name)``."""
    if not logdir:
        with torch.profiler.record_function(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir, worker_name=name),
    ):
        with torch.profiler.record_function(name):
            yield


class StepTimer:
    """Blocked wall-clock timing of train steps.

    The caller blocks inside the step, as JAX's ``block_until_ready`` does
    there: CUDA runs asynchronously, so call ``torch.cuda.synchronize()``
    before the step's block ends, or the timer reads the launch time::

        timer = StepTimer()
        for batch in loader:
            with timer.step():
                state, metrics = train_step(state, batch)
                torch.cuda.synchronize()
        print(timer.summary())
    """

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        """Stats over the recorded steps, the first ``skip_first`` (warm-up:
        kernel builds, allocator growth) left out."""
        times = np.asarray(self.times[skip_first:] or self.times)
        if len(times) == 0:
            return {}
        return {
            "steps": int(len(times)),
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p90_s": float(np.percentile(times, 90)),
            "steps_per_sec": float(1.0 / max(times.mean(), 1e-12)),
        }
