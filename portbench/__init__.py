"""The benchmark of the PyTorch/CUDA port (``neural_sound_generation_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell needs is
found by name: its configuration in ``configs/``, its traffic mix in
``traffic/``, the family adapter the configuration names in ``families/``,
the driver the traffic names in ``drivers/``, its correctness limits in
``limits/`` and each per-layer metric's reader in ``metrics/``. The plain
float32 references in ``reference/`` import nothing of the port.
"""
