"""ctypes binding to the native motion-capture runtime.

Counterpart of ``neural_sound_generation_tpu/motion/capture.py``: the same
C ABI of ``native/motion.cpp`` (a copy of the JAX package's source) bound the
same way, with push callbacks from the producer thread through ``CFUNCTYPE``
and pull access by ``poll``/``read``/``drain``.

The library is compiled at first use by the ``g++`` on ``PATH`` with the
flags of ``native/Makefile`` into ``build/native/`` (``native_build``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from neural_sound_generation_tpu_torch import native_build

NATIVE_SOURCE = Path(__file__).resolve().parent / "native" / "motion.cpp"
BUILD_DIR = native_build.BUILD_DIR
LINK_FLAGS = ("-lpthread",)  # native/Makefile's link line
_lib = None
_lib_lock = threading.Lock()

_CALLBACK_TYPE = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p
)
_GESTURE_CALLBACK_TYPE = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_double), ctypes.c_void_p
)

NUM_FEATURES = 18  # 3 palm angles + 5 fingers x 3 joint angles
GESTURE_DOUBLES = 13  # serialized gesture record width

# Leap SDK numeric conventions (Gesture.Type / Gesture.State)
GESTURE_TYPE_SWIPE = 1
GESTURE_TYPE_CIRCLE = 4
GESTURE_TYPE_SCREEN_TAP = 5
GESTURE_TYPE_KEY_TAP = 6
GESTURE_STATE_START = 1
GESTURE_STATE_UPDATE = 2
GESTURE_STATE_STOP = 3

GESTURE_TYPE_NAMES = {
    GESTURE_TYPE_SWIPE: "swipe",
    GESTURE_TYPE_CIRCLE: "circle",
    GESTURE_TYPE_SCREEN_TAP: "screen_tap",
    GESTURE_TYPE_KEY_TAP: "key_tap",
}
GESTURE_STATE_NAMES = {
    GESTURE_STATE_START: "start",
    GESTURE_STATE_UPDATE: "update",
    GESTURE_STATE_STOP: "stop",
}


class GestureEvent:
    """One recognized gesture event.

    ``progress`` is cumulative turns for circles and displacement (mm) for
    swipes; ``direction`` is the circle-plane normal for circles and the
    motion direction for swipes/taps; ``clockwise`` compares the pointable's
    direction with the circle's normal."""

    __slots__ = ("type", "state", "id", "progress", "radius", "clockwise",
                 "speed", "direction", "position")

    def __init__(self, record: np.ndarray):
        self.type = int(record[0])
        self.state = int(record[1])
        self.id = int(record[2])
        self.progress = float(record[3])
        self.radius = float(record[4])
        self.clockwise = bool(record[5])
        self.speed = float(record[6])
        self.direction = np.asarray(record[7:10], np.float64)
        self.position = np.asarray(record[10:13], np.float64)

    @property
    def type_name(self) -> str:
        return GESTURE_TYPE_NAMES.get(self.type, f"type{self.type}")

    @property
    def state_name(self) -> str:
        return GESTURE_STATE_NAMES.get(self.state, f"state{self.state}")

    def __repr__(self):
        extra = ""
        if self.type == GESTURE_TYPE_CIRCLE:
            extra = (f", progress={self.progress:.2f}, radius={self.radius:.1f}"
                     f", {'clockwise' if self.clockwise else 'counterclockwise'}")
        elif self.type == GESTURE_TYPE_SWIPE:
            extra = f", speed={self.speed:.0f}"
        return (f"GestureEvent({self.type_name}, {self.state_name}, "
                f"id={self.id}{extra})")


def library_path() -> Path:
    """Where the library of this source, compiler and flags lives."""
    return native_build.library_path(NATIVE_SOURCE, "libnsgmotion", LINK_FLAGS,
                                     "the motion runtime")


def build(path: Path) -> None:
    """Compile ``native/motion.cpp`` into ``path``."""
    native_build.build(NATIVE_SOURCE, path, LINK_FLAGS, "the motion runtime")


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """Build (once per digest, or again with ``rebuild`` on the first load
    in a process) and load the library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if rebuild or not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        lib.nsg_num_features.restype = ctypes.c_int
        lib.nsg_replay_controller_new.restype = ctypes.c_void_p
        lib.nsg_replay_controller_new.argtypes = [
            ctypes.c_char_p, ctypes.c_double, ctypes.c_int,
        ]
        lib.nsg_synthetic_controller_new.restype = ctypes.c_void_p
        lib.nsg_synthetic_controller_new.argtypes = [
            ctypes.c_uint64, ctypes.c_double, ctypes.c_int64,
        ]
        lib.nsg_controller_free.argtypes = [ctypes.c_void_p]
        lib.nsg_controller_start.argtypes = [ctypes.c_void_p]
        lib.nsg_controller_stop.argtypes = [ctypes.c_void_p]
        lib.nsg_controller_running.argtypes = [ctypes.c_void_p]
        lib.nsg_controller_running.restype = ctypes.c_int
        lib.nsg_controller_done.argtypes = [ctypes.c_void_p]
        lib.nsg_controller_done.restype = ctypes.c_int
        lib.nsg_controller_length.argtypes = [ctypes.c_void_p]
        lib.nsg_controller_length.restype = ctypes.c_int64
        lib.nsg_controller_poll.restype = ctypes.c_int64
        lib.nsg_controller_poll.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.nsg_controller_read.restype = ctypes.c_int64
        lib.nsg_controller_read.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ]
        lib.nsg_controller_drain.restype = ctypes.c_int64
        lib.nsg_controller_drain.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.nsg_controller_set_callback.argtypes = [
            ctypes.c_void_p, _CALLBACK_TYPE, ctypes.c_void_p,
        ]
        lib.nsg_record_csv.restype = ctypes.c_int64
        lib.nsg_record_csv.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.nsg_extract_features.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.nsg_scripted_controller_new.restype = ctypes.c_void_p
        lib.nsg_scripted_controller_new.argtypes = [ctypes.c_double]
        lib.nsg_gesture_record_size.restype = ctypes.c_int
        lib.nsg_controller_poll_gestures.restype = ctypes.c_int
        lib.nsg_controller_poll_gestures.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.nsg_controller_set_gesture_callback.argtypes = [
            ctypes.c_void_p, _GESTURE_CALLBACK_TYPE, ctypes.c_void_p,
        ]
        if lib.nsg_num_features() != NUM_FEATURES:
            raise RuntimeError(f"{path}: {lib.nsg_num_features()} features, "
                               f"expected {NUM_FEATURES}")
        if lib.nsg_gesture_record_size() != GESTURE_DOUBLES:
            raise RuntimeError(f"{path}: gesture records of {lib.nsg_gesture_record_size()} "
                               f"doubles, expected {GESTURE_DOUBLES}")
        _lib = lib
        return lib


class MotionController:
    """Pythonic handle over a native controller.

    ``add_listener(fn)`` registers a per-frame callback invoked from the
    native producer thread; ``poll``/``read`` give pull access;
    ``drain``/``record_csv`` run synchronously.
    """

    def __init__(self, handle: int):
        if not handle:
            raise ValueError("native controller creation failed")
        self._lib = load_library()
        self._handle = ctypes.c_void_p(handle)
        self._listeners: List[Callable[[np.ndarray], None]] = []
        self._cb_ref = None  # keep the CFUNCTYPE object alive
        self._gesture_listeners: List[Callable[[GestureEvent], None]] = []
        self._gesture_cb_ref = None

    def _h(self):
        """Live handle or ValueError: native calls on a closed controller
        would dereference NULL and kill the process."""
        if self._handle is None:
            raise ValueError("controller is closed")
        return self._handle

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._listeners and self._cb_ref is None:
            self._install_callback()
        self._lib.nsg_controller_start(self._h())
        return self

    def stop(self):
        self._lib.nsg_controller_stop(self._h())

    def close(self):
        if self._handle:
            self._lib.nsg_controller_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        self.close()

    @property
    def running(self) -> bool:
        return bool(self._lib.nsg_controller_running(self._h()))

    @property
    def done(self) -> bool:
        return bool(self._lib.nsg_controller_done(self._h()))

    def __len__(self) -> int:
        n = self._lib.nsg_controller_length(self._h())
        if n < 0:
            raise TypeError("unbounded stream has no length")
        return int(n)

    # -- push (Listener model) ------------------------------------------
    def add_listener(self, fn: Callable[[np.ndarray], None]):
        self._listeners.append(fn)
        if self.running and self._cb_ref is None:
            self._install_callback()
        return self

    def _install_callback(self):
        def trampoline(ptr, n, _user):
            feats = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
            for fn in self._listeners:
                fn(feats)

        self._cb_ref = _CALLBACK_TYPE(trampoline)
        self._lib.nsg_controller_set_callback(self._h(), self._cb_ref, None)

    # -- gestures --------------------------------------------------------
    def add_gesture_listener(self, fn: Callable[["GestureEvent"], None]):
        """Push delivery of recognized gestures from the producer thread."""
        self._gesture_listeners.append(fn)
        if self._gesture_cb_ref is None:
            self._install_gesture_callback()
        return self

    def _install_gesture_callback(self):
        def trampoline(ptr, _user):
            rec = np.ctypeslib.as_array(ptr, shape=(GESTURE_DOUBLES,)).copy()
            event = GestureEvent(rec)
            for fn in self._gesture_listeners:
                fn(event)

        self._gesture_cb_ref = _GESTURE_CALLBACK_TYPE(trampoline)
        self._lib.nsg_controller_set_gesture_callback(
            self._h(), self._gesture_cb_ref, None
        )

    def poll_gestures(self, max_events: int = 256) -> List["GestureEvent"]:
        """Pop pending gesture events (pull model)."""
        buf = np.zeros((max_events, GESTURE_DOUBLES), np.float64)
        n = self._lib.nsg_controller_poll_gestures(
            self._h(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            max_events,
        )
        return [GestureEvent(buf[i]) for i in range(n)]

    # -- pull ------------------------------------------------------------
    def poll(self) -> Optional[np.ndarray]:
        out = (ctypes.c_double * NUM_FEATURES)()
        fid = self._lib.nsg_controller_poll(self._h(), out, NUM_FEATURES)
        if fid < 0:
            return None
        return np.ctypeslib.as_array(out).copy()

    def read(self, after_id: int = -1, timeout: float = 5.0):
        """(frame_id, features) blocking; None at stream end."""
        out = (ctypes.c_double * NUM_FEATURES)()
        fid = self._lib.nsg_controller_read(
            self._h(), after_id, out, NUM_FEATURES, timeout
        )
        if fid < 0:
            return None
        return int(fid), np.ctypeslib.as_array(out).copy()

    def drain(self, n_frames: int) -> np.ndarray:
        """Synchronously fetch up to n_frames rows (no producer thread)."""
        if self.running:
            raise RuntimeError(
                "drain() consumes the stream directly; stop() the "
                "controller first (use poll()/read() while streaming)"
            )
        buf = np.zeros((n_frames, NUM_FEATURES), np.float64)
        got = self._lib.nsg_controller_drain(
            self._h(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_frames,
        )
        return buf[:got]

    def record_csv(self, path: str, n_frames: int) -> int:
        """Capture joint-angle rows to a CSV file."""
        if self.running:
            raise RuntimeError("stop() the controller before record_csv()")
        got = self._lib.nsg_record_csv(
            self._h(), path.encode(), n_frames
        )
        if got < 0:
            raise IOError(f"cannot write {path}")
        return int(got)


def replay_controller(
    csv_path: str, fps: float = 60.0, loop: bool = False
) -> MotionController:
    """Stream a recorded joint-angle CSV at frame rate."""
    lib = load_library()
    handle = lib.nsg_replay_controller_new(csv_path.encode(), fps, int(loop))
    if not handle:
        raise FileNotFoundError(f"no usable rows in {csv_path}")
    return MotionController(handle)


def synthetic_controller(
    seed: int = 0, fps: float = 60.0, n_frames: int = -1
) -> MotionController:
    """Deterministic synthetic hand (full scene graph animated in C++)."""
    lib = load_library()
    return MotionController(lib.nsg_synthetic_controller_new(seed, fps, n_frames))


def scripted_gesture_controller(fps: float = 60.0) -> MotionController:
    """Deterministic gesture choreography: a hand performing a clockwise
    circle, a counterclockwise circle, a rightward swipe, a key tap and a
    screen tap, for driving the gesture recognizers without a device."""
    lib = load_library()
    return MotionController(lib.nsg_scripted_controller_new(fps))


def extract_features_native(scene: np.ndarray) -> np.ndarray:
    """Run the C++ joint-angle extraction on a raw scene dump
    [dir(3), normal(3), 20 bone dirs (60)], for parity testing."""
    lib = load_library()
    scene = np.ascontiguousarray(scene, np.float64)
    assert scene.shape == (66,)
    out = np.zeros(NUM_FEATURES, np.float64)
    lib.nsg_extract_features(
        scene.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
