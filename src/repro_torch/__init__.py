"""PyTorch/CUDA port of the Sparse Allreduce system (``src/repro``).

The package mirrors ``repro`` module for module: ``core`` (topology,
simulator, stacked-mesh transport, union and planned reduce, public API),
``kernels`` (hand-written Hopper CUDA kernels beside their plain PyTorch
versions), ``data`` and ``graph`` (PageRank on the device engine).  It
imports ``torch`` and numpy only -- never ``jax`` nor ``repro`` -- so it
runs where the reference package cannot be installed.
"""
