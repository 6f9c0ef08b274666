"""The port's WaveNet stream multiplexer (serving/mux.py), on the CPU: the
properties tests/test_serving_mux.py holds the JAX multiplexer to. The
load-bearing one is isolation: a session's audio is a function of its
conditioning and seed alone, bit for bit, whichever slots are live, when it
joined and which slot it landed on. Beyond those, a session equals the
chunked sampler fed its per-chunk noise."""

import threading
import time

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu_torch.models import wavenet as wn
from neural_sound_generation_tpu_torch.serving import MuxOverloaded, WaveNetStreamMux
from neural_sound_generation_tpu_torch.serving.mux import chunk_seed

torch.set_num_threads(1)

TINY = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16, skip_out_channels=8,
            out_channels=30, kernel_size=2, cin_channels=4, gin_channels=-1,
            scalar_input=True, upsample_scales=(2, 2))


@pytest.fixture(scope="module")
def tiny():
    return wn.WaveNet(**TINY, generator=torch.Generator().manual_seed(0)).eval()


def _mux(model, slots=4, **kw):
    # l_max = ceil(1.0 * 256 / 32) * 32 = 256 samples (8 chunks)
    return WaveNetStreamMux(model, chunk=32, slots=slots, dtype=None, max_seconds=1.0,
                            sample_rate=256, **kw)


def _cond(seed, frames=16):
    return np.random.RandomState(seed).randn(frames, 4).astype(np.float32)


def _collect(gen):
    return np.concatenate(list(gen))


def _wait_idle(mux, timeout=10.0):
    """Until no session is queued, live or in flight: a worker thread still
    inside a chunk when the interpreter exits can abort the process."""
    deadline = time.time() + timeout
    while (mux.active or mux.pending or mux.busy) and time.time() < deadline:
        time.sleep(0.02)
    assert not (mux.active or mux.pending or mux.busy)


def _join(threads, timeout=120):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


def test_session_length_and_range(tiny):
    out = _collect(_mux(tiny).open(_cond(0, frames=15), 7))
    assert out.shape == (15 * 4,)  # upsample x4, final chunk trimmed
    assert out.dtype == np.float32 and np.isfinite(out).all() and np.abs(out).max() <= 1.0


def test_deterministic_per_seed(tiny):
    mux = _mux(tiny)
    a = _collect(mux.open(_cond(1), 3))
    b = _collect(mux.open(_cond(1), 3))
    c = _collect(mux.open(_cond(1), 4))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)  # the seed drives the sampling


def test_session_is_the_chunked_sampler_with_per_chunk_noise(tiny):
    """Two chunks of 32: each chunk's noise is drawn from a generator
    seeded with chunk_seed(seed, ordinal) in draw_noise's layout (within
    1e-6: see below)."""
    seed, frames = 5, 16
    got = _collect(_mux(tiny).open(_cond(2, frames), seed))
    init_state, step_chunk, _ = wn.make_chunked_generate_fn(tiny, chunk=32)
    with torch.no_grad():
        c_up = wn._upsample_cond(tiny, torch.from_numpy(_cond(2, frames))[None])
    state, outs = init_state(1), []
    for k in range(2):
        gum, unif = wn.draw_noise(tiny, torch.Generator().manual_seed(chunk_seed(seed, k)), 32)
        state, out = step_chunk(state, c_up[:, 32 * k : 32 * (k + 1)], gum, unif, None)
        outs.append(out[0])
    # the mux steps 4 slots at once and this loop one: the CPU's matrix
    # products block a batch of 4 otherwise than a batch of 1 (float32 ulps)
    np.testing.assert_allclose(got, torch.cat(outs).numpy(), atol=1e-6, rtol=0)
    assert chunk_seed(seed, 0) != chunk_seed(seed, 1) != chunk_seed(seed + 1, 0)


def test_isolation_from_concurrent_sessions(tiny):
    """Bitwise the same alone or beside sessions in neighbouring slots."""
    mux = _mux(tiny)
    solo = _collect(mux.open(_cond(2), 11))
    results = {}

    def run(name, cond_seed, seed):
        results[name] = _collect(mux.open(_cond(cond_seed), seed))

    threads = [threading.Thread(target=run, args=args)
               for args in (("a", 2, 11), ("b", 5, 12), ("c", 6, 13))]
    for t in threads:
        t.start()
    _join(threads)
    np.testing.assert_array_equal(results["a"], solo)
    assert results["b"].shape == solo.shape
    assert not np.array_equal(results["b"], results["c"])


def test_more_sessions_than_slots(tiny):
    """Sessions queue for slots and every one completes (slot reuse)."""
    mux = _mux(tiny, slots=2)
    results = [None] * 5

    def run(i):
        results[i] = _collect(mux.open(_cond(10 + i), i))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    _join(threads, 180)
    for r in results:
        assert r is not None and r.shape == (16 * 4,)
    assert mux.active == 0  # drained completely


def test_capacity_guard(tiny):
    with pytest.raises(ValueError, match="slot capacity"):
        _mux(tiny).open(_cond(0, frames=100), 0)  # 400 > 256
    with pytest.raises(ValueError, match="conditioning"):
        _mux(tiny).open(np.zeros((8, 3), np.float32), 0)


def test_capacity_honors_stated_seconds_bound(tiny):
    """ceil(max_seconds * sr / chunk) chunks: 240 samples fit a 250-sample cap."""
    mux = WaveNetStreamMux(tiny, chunk=32, slots=2, dtype=None, max_seconds=1.0,
                           sample_rate=250)
    assert mux.l_max >= 250
    assert _collect(mux.open(_cond(3, frames=60), 5)).shape == (240,)


def test_discrete_output_mode():
    """Categorical (mulaw-quantize) models stream integer sample ids."""
    model = wn.WaveNet(**{**TINY, "layers": 2, "stacks": 1, "out_channels": 16,
                          "scalar_input": False, "quantize_channels": 16},
                       generator=torch.Generator().manual_seed(1)).eval()
    out = _collect(_mux(model, slots=2).open(_cond(3, frames=9), 5))
    assert out.shape == (9 * 4,) and out.dtype == np.int64
    assert (out >= 0).all() and (out < 16).all()


def test_slot_reuse_determinism(tiny):
    """Sequential sessions with the same input reuse slot 0 right after the
    previous occupant: the fresh slot's state is zeroed every time."""
    mux = _mux(tiny)
    first = _collect(mux.open(_cond(8), 21))
    for _ in range(4):
        np.testing.assert_array_equal(first, _collect(mux.open(_cond(8), 21)))


def test_crash_wakes_session_finished_in_lookahead(tiny):
    """A worker failure wakes every session still in a slot with the
    exception; a session whose final chunk was delivered before the failure
    keeps its audio (each chunk is delivered right after it is computed)."""
    mux = _mux(tiny, slots=2)
    orig = mux._dispatch
    calls = {"n": 0}
    b_queued = threading.Event()

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            b_queued.wait(timeout=60)
            return orig(*a, **k)
        raise RuntimeError("injected device failure")

    mux._dispatch = boom
    results = {}

    def consume(name, gen):
        try:
            results[name] = _collect(gen)
        except Exception as e:  # noqa: BLE001 — the test inspects it
            results[name] = e

    # A finishes at the first dispatch (8 frames x4 = one chunk) and is
    # delivered; B needs a second, which raises
    ta = threading.Thread(target=consume, args=("a", mux.open(_cond(9, frames=8), 1)))
    ta.start()
    gen_b = mux.open(_cond(9, frames=16), 2)
    b_queued.set()
    tb = threading.Thread(target=consume, args=("b", gen_b))
    tb.start()
    _join([ta, tb])
    assert isinstance(results["a"], np.ndarray) and results["a"].shape == (32,)
    assert isinstance(results["b"], RuntimeError)
    assert not mux.busy and mux.active == 0 and mux.pending == 0


def test_max_pending_admission_control(tiny):
    """Once max_pending sessions wait beyond the free slots, open() raises
    MuxOverloaded; a free slot always admits."""
    mux = _mux(tiny, slots=1, max_pending=1)
    orig = mux._dispatch
    release = threading.Event()

    def slow(*a, **k):
        release.wait(timeout=120)
        return orig(*a, **k)

    mux._dispatch = slow
    gen_a = mux.open(_cond(0, frames=8), 1)  # slot 0
    deadline = time.time() + 30
    while mux.active < 1 and time.time() < deadline:
        time.sleep(0.01)
    gen_b = mux.open(_cond(1, frames=8), 2)  # pending 1
    with pytest.raises(MuxOverloaded, match="retry later"):
        mux.open(_cond(2, frames=8), 3)
    release.set()
    assert _collect(gen_a).shape == (32,)
    assert _collect(gen_b).shape == (32,)


def test_early_close_cancels_session(tiny):
    """An abandoned stream frees its slot and stops growing its queue."""
    mux = _mux(tiny, slots=2)
    h = mux.open(_cond(1, frames=64), 0)  # 256 samples = 8 chunks
    assert next(iter(h)).shape == (32,)
    h.close()
    _wait_idle(mux)
    time.sleep(0.3)
    assert h._sess.queue.qsize() <= 1  # at most the chunk in flight at close()
    out = _collect(mux.open(_cond(2, frames=16), 1))
    assert out.shape == (16 * 4,) and np.isfinite(out).all()


def test_close_before_first_chunk_cancels(tiny):
    """close() on a handle never iterated cancels too."""
    mux = _mux(tiny, slots=2)
    h = mux.open(_cond(3, frames=64), 2)
    h.close()
    _wait_idle(mux)
