"""The benchmark of the PyTorch and CUDA port (``specenh_torch``): see
``run.py`` and ``BENCHMARK.json`` at the repo root."""
