"""The port's native motion runtime held against the JAX package's on the
CPU, both in one process: the port builds its own copy of ``motion.cpp``
with g++ into ``build/native/`` and never loads the JAX package's library.
Both are built from the same source with the same flags, so frames, CSV
bytes and gesture events must be equal bit for bit."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from neural_sound_generation_tpu.motion import capture as jcap
from neural_sound_generation_tpu_torch.motion import capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "motion_golden.npz")


def _drain(mod, make, n):
    c = make(mod)
    try:
        return c.drain(n)
    finally:
        c.close()


def _events(mod, fps):
    c = mod.scripted_gesture_controller(fps=fps)
    try:
        frames = c.drain(len(c))
        events = c.poll_gestures(max_events=4096)
    finally:
        c.close()
    return frames, events


def _record(e):
    return (e.type, e.state, e.id, e.progress, e.radius, e.clockwise, e.speed,
            tuple(e.direction), tuple(e.position))


def test_library_is_the_ports_own_build():
    """In a fresh interpreter: the library comes from build/native/ under a
    digest of compiler, flags and source, and the JAX package's library is
    never mapped into the process."""
    code = (
        "from neural_sound_generation_tpu_torch.motion import capture\n"
        "c = capture.synthetic_controller(seed=1, n_frames=4)\n"
        "assert c.drain(4).shape == (4, 18)\n"
        "c.close()\n"
        "print(capture.library_path())\n"
        "print(capture.load_library().nsg_num_features())\n"
        "maps = open('/proc/self/maps').read().splitlines()\n"
        "print(sorted({l.split()[-1] for l in maps if 'libnsgmotion' in l}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    path, features, mapped = out.stdout.strip().splitlines()
    assert path == str(capture.library_path())
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libnsgmotion-")
    assert features == "18"
    assert mapped == repr([path])
    with open(capture.NATIVE_SOURCE, "rb") as a, open(
            os.path.join(os.path.dirname(jcap.__file__), "native", "motion.cpp"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("make, n", [
    (lambda m: m.synthetic_controller(seed=7, n_frames=50), 50),
    (lambda m: m.synthetic_controller(seed=8, fps=500.0, n_frames=40), 40),
    (lambda m: m.synthetic_controller(seed=3), 64),  # unbounded stream
], ids=["seed7", "seed8_fps500", "unbounded"])
def test_synthetic_frames_equal_jax(make, n):
    got, want = _drain(capture, make, n), _drain(jcap, make, n)
    assert got.shape == (n, capture.NUM_FEATURES)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and np.abs(got[:, 3:]).max() <= 1.0 + 1e-9


def test_golden_frames():
    frames = _drain(capture, lambda m: m.synthetic_controller(seed=123, n_frames=16), 16)
    np.testing.assert_allclose(frames, np.load(GOLDEN)["frames"], atol=1e-12)


def test_feature_extraction_matches_numpy_and_jax():
    rng = np.random.default_rng(4)
    direction = rng.standard_normal(3)
    direction /= np.linalg.norm(direction)
    normal = rng.standard_normal(3)
    normal /= np.linalg.norm(normal)
    bones = rng.standard_normal((5, 4, 3))
    bones /= np.linalg.norm(bones, axis=-1, keepdims=True)
    scene = np.concatenate([direction, normal, bones.reshape(-1)])
    got = capture.extract_features_native(scene)
    expected = [np.arctan2(direction[1], -direction[2]),
                np.arctan2(normal[0], -normal[1]),
                np.arctan2(direction[0], -direction[2])]
    for f in range(5):
        for b in range(1, 4):
            expected.append(float(np.dot(bones[f, b - 1], bones[f, b])))
    np.testing.assert_allclose(got, expected, atol=1e-12)
    np.testing.assert_array_equal(got, jcap.extract_features_native(scene))


def test_record_csv_bytes_equal_jax_and_replay(tmp_path):
    paths = {}
    for name, mod in (("port", capture), ("jax", jcap)):
        paths[name] = str(tmp_path / f"{name}.csv")
        c = mod.synthetic_controller(seed=1, n_frames=40)
        try:
            assert c.record_csv(paths[name], 40) == 40
        finally:
            c.close()
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    rep = capture.replay_controller(paths["port"])
    try:
        assert len(rep) == 40
        frames = rep.drain(40)
    finally:
        rep.close()
    expected = _drain(capture, lambda m: m.synthetic_controller(seed=1, n_frames=40), 40)
    np.testing.assert_allclose(frames, expected, atol=1e-12)


@pytest.mark.parametrize("loop", [False, True])
def test_replay_equals_jax(tmp_path, loop):
    path = str(tmp_path / "small.csv")
    rows = np.random.default_rng(2).standard_normal((3, 18))
    np.savetxt(path, rows, delimiter=",")
    make = lambda m: m.replay_controller(path, fps=90.0, loop=loop)  # noqa: E731
    got, want = _drain(capture, make, 7), _drain(jcap, make, 7)
    np.testing.assert_array_equal(got, want)
    if loop:
        assert got.shape == (7, 18)
        np.testing.assert_array_equal(got[0], got[3])  # wrapped
    else:
        assert got.shape == (3, 18)


def test_replay_missing_file_matches_jax():
    path = "/nonexistent-dir/no-such-recording.csv"
    with pytest.raises(FileNotFoundError) as port_err:
        capture.replay_controller(path)
    with pytest.raises(FileNotFoundError) as jax_err:
        jcap.replay_controller(path)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("fps", [60.0, 115.0])
def test_scripted_gesture_events_equal_jax(fps):
    frames, events = _events(capture, fps)
    jframes, jevents = _events(jcap, fps)
    np.testing.assert_array_equal(frames, jframes)
    assert [_record(e) for e in events] == [_record(e) for e in jevents]
    types = {e.type for e in events}
    assert types == {capture.GESTURE_TYPE_CIRCLE, capture.GESTURE_TYPE_SWIPE,
                     capture.GESTURE_TYPE_KEY_TAP, capture.GESTURE_TYPE_SCREEN_TAP}
    starts = [e for e in events if e.type == capture.GESTURE_TYPE_CIRCLE
              and e.state == capture.GESTURE_STATE_START]
    assert [e.clockwise for e in starts] == [True, False]
    assert [repr(e) for e in events] == [repr(e) for e in jevents]


def test_listener_callbacks_arrive_from_the_native_thread():
    received, threads = [], set()
    ctrl = capture.synthetic_controller(seed=0, fps=1000.0, n_frames=30)

    def on_frame(f):
        received.append(f.copy())
        threads.add(threading.get_ident())

    ctrl.add_listener(on_frame)
    try:
        ctrl.start()
        deadline = time.time() + 5.0
        while not ctrl.done and time.time() < deadline:
            time.sleep(0.01)
    finally:
        ctrl.stop()
        ctrl.close()
    assert len(received) >= 25
    assert all(f.shape == (18,) for f in received)
    assert threads and threading.get_ident() not in threads
    want = _drain(jcap, lambda m: m.synthetic_controller(seed=0, fps=1000.0, n_frames=30), 30)
    np.testing.assert_array_equal(np.stack(received), want[:len(received)])


def test_gesture_push_callbacks_from_the_native_thread():
    got, threads = [], set()
    seen_circle = threading.Event()

    def on_gesture(event):
        got.append(event)
        threads.add(threading.get_ident())
        if event.type == capture.GESTURE_TYPE_CIRCLE:
            seen_circle.set()

    c = capture.scripted_gesture_controller(fps=1000.0)
    c.add_gesture_listener(on_gesture)
    try:
        c.start()
        assert seen_circle.wait(timeout=20.0)
    finally:
        c.stop()
        c.close()
    assert any(e.type == capture.GESTURE_TYPE_CIRCLE for e in got)
    assert threading.get_ident() not in threads


def test_streaming_thread_poll_and_read():
    ctrl = capture.synthetic_controller(seed=0, fps=500.0, n_frames=100)
    try:
        ctrl.start()
        deadline = time.time() + 5.0
        while ctrl.poll() is None and time.time() < deadline:
            time.sleep(0.005)
        frame = ctrl.poll()
        assert frame is not None and frame.shape == (18,)
        fid, feats = ctrl.read(after_id=0, timeout=5.0)
        assert fid >= 1 and feats.shape == (18,)
        with pytest.raises(RuntimeError, match="stop"):
            ctrl.drain(1)
        ctrl.stop()
        assert not ctrl.running
    finally:
        ctrl.close()


def test_restart_after_exhaustion_and_closed_handle():
    ctrl = capture.synthetic_controller(seed=3, fps=2000.0, n_frames=5)
    try:
        ctrl.start()
        deadline = time.time() + 20
        while not ctrl.done and time.time() < deadline:
            time.sleep(0.01)
        assert ctrl.done
        ctrl.start()
        ctrl.stop()
    finally:
        ctrl.close()
    for call in (ctrl.stop, lambda: ctrl.running, ctrl.poll, lambda: len(ctrl)):
        with pytest.raises(ValueError, match="closed"):
            call()
    ctrl.close()  # idempotent


def test_record_csv_rejects_bad_frame_counts(tmp_path):
    ctrl = capture.scripted_gesture_controller(fps=200.0)
    out = str(tmp_path / "x.csv")
    try:
        for n in (-1, 1 << 40):
            with pytest.raises(IOError):
                ctrl.record_csv(out, n)
        assert ctrl.record_csv(out, 3) == 3
    finally:
        ctrl.close()
    unbounded = capture.synthetic_controller(seed=0)
    try:
        with pytest.raises(TypeError, match="unbounded"):
            len(unbounded)
    finally:
        unbounded.close()


def test_gestures_absent_for_feature_only_replay(tmp_path):
    csv = str(tmp_path / "rec.csv")
    cap = capture.synthetic_controller(seed=5, n_frames=64)
    try:
        cap.record_csv(csv, 64)
    finally:
        cap.close()
    rep = capture.replay_controller(csv)
    try:
        rep.drain(64)
        assert rep.poll_gestures() == []
    finally:
        rep.close()
