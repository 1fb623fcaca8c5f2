"""Hand-written Hopper kernels of the PyTorch port (reference: ``repro.kernels``).

``rank_merge`` / ``onehot_scatter`` / ``spmv_ell`` each hold a CUDA C++
kernel (sources under ``csrc/``, built by ``_build`` with ``nvcc`` into one
shared library loaded through ``ctypes``) beside its plain PyTorch version
(``ref``).  A wrapper launches its kernel for CUDA tensors and runs the
plain version only for CPU tensors.  ``ops`` composes them into the fused
merge pipeline.  ``trim_runs`` (the union path's final compaction) is a
kernel of the port alone, with no TPU kernel behind it.
"""
