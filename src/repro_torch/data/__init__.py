"""Synthetic data of the PyTorch port (reference: ``repro.data``)."""
