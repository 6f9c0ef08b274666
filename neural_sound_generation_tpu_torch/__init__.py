"""PyTorch and CUDA port of ``neural_sound_generation_tpu``.

The module layout mirrors the JAX package, so each module's counterpart has
the same path under the other package. This package imports ``torch`` and
never ``jax``, ``flax`` or the JAX package. Its entry points run on a CUDA
device unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
