"""Optimizers of the port (reference: ``repro.optim``)."""
