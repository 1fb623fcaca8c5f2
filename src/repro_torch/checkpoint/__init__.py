"""Checkpoint store of the PyTorch port (reference: ``repro.checkpoint``)."""
