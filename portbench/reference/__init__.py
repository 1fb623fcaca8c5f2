"""Plain references in PyTorch and NumPy.  Nothing here imports the port
(``repro_torch``), the JAX package or JAX."""
