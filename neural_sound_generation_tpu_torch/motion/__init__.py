"""The motion path: the native capture runtime, PCA and motion-conditioned
generation. Counterpart of ``neural_sound_generation_tpu/motion``."""

from neural_sound_generation_tpu_torch.motion.capture import (  # noqa: F401
    GESTURE_STATE_START,
    GESTURE_STATE_STOP,
    GESTURE_STATE_UPDATE,
    GESTURE_TYPE_CIRCLE,
    GESTURE_TYPE_KEY_TAP,
    GESTURE_TYPE_SCREEN_TAP,
    GESTURE_TYPE_SWIPE,
    GestureEvent,
    MotionController,
    NUM_FEATURES,
    replay_controller,
    scripted_gesture_controller,
    synthetic_controller,
)
from neural_sound_generation_tpu_torch.motion.pca import (  # noqa: F401
    PCAProjector,
    run_pca,
    run_pca_np,
)
