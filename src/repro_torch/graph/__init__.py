"""Graph applications of the PyTorch port (reference: ``repro.graph``)."""
