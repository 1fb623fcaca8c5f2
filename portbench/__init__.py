"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the command; ``harness.py`` finds a cell's configuration,
traffic, runner and metric readers by the names in ``BENCHMARK.json``.
Nothing here imports the JAX package or JAX.
"""
