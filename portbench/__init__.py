"""The benchmark of mini_nbody_tpu_torch, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, cell, traffic kind, layer or per-layer
metric lives in a file of its own here (``configs/``, ``workloads/``,
``traffic/``, ``layers/``, ``metrics/``), found by name. The yardstick
(inputs, the plain reference, the problem's work and the card's peaks,
the reading of the profiler trace) is this package's own: it imports the
port only to drive it, and never JAX or the JAX package.
"""
