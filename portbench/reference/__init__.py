"""Plain float32 PyTorch references of what the benchmark's cells time.

Written from the published descriptions, independent of the port: nothing
here imports ``neural_sound_generation_tpu_torch``, its JAX counterpart or
JAX. Parameters are dicts of tensors under the port's parameter names, so
that the benchmark can hand the same seeded weights to both sides.
"""
