"""The benchmark of ``voicepuppet_torch`` on NVIDIA GPUs: cells, traffic,
the plain reference, the comparisons that decide ``correct`` and the
readers of the per-layer metrics.  ``python -m benchmark.run --help``."""
