"""Sparse Allreduce core of the PyTorch port (reference: ``repro.core``).

Submodules are imported explicitly (``repro_torch.core.api`` etc.); this
package init stays empty so that importing one host module does not pull
in the device stack.
"""
