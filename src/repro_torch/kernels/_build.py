"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` into an object file; one ``nvcc -shared`` link makes a
single shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused.  Nothing here runs
at import time: the first kernel launch calls :func:`library`.

The module also keeps the kernels' launch counts: each wrapper adds one
to its kernel's entry of :data:`LAUNCHES` where it launches the kernel,
and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("rank_merge.cu", "rank_merge_banded.cu", "onehot_scatter.cu",
           "banded_onehot_scatter.cu", "spmv_ell.cu", "spmv_csr.cu",
           "trim_runs.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# One entry per TPU kernel (scaled variants apart from their unscaled ones),
# plus ``row_order``, the dense scatter's layout stages, and
# ``banded_windows``, the banded scatter's window table, each launched on
# its own, and ``trim_runs``, the union path's final compaction, which
# replaces no TPU kernel.
LAUNCHES: Dict[str, int] = {
    "rank_counts": 0, "rank_counts_banded": 0, "onehot_scatter_add": 0,
    "onehot_scatter_add_scaled": 0, "banded_onehot_scatter_add": 0,
    "banded_onehot_scatter_add_scaled": 0, "spmv_ell": 0, "spmv_csr": 0,
    "row_order": 0, "banded_windows": 0, "trim_runs": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argtypes (pointers and the stream as c_void_p).
_SIGNATURES = {
    "repro_rank_counts": (_P, _P, _P, _P, _LL, _I, _LL, _I, _LL, _I, _P),
    "repro_rank_counts_banded": (_P, _P, _P, _P, _P, _LL, _I, _LL, _I, _LL,
                                 _I, _I, _I, _I, _P),
    "repro_onehot_scatter_add": (_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P,
                                 _P, _P),
    "repro_row_order": (_P, _LL, _LL, _LL, _P, _P, _P),
    "repro_banded_onehot_scatter_add": (_P, _P, _P, _P, _LL, _LL, _LL, _I,
                                        _I, _P, _LL, _P),
    "repro_banded_windows": (_P, _P, _LL, _LL, _LL, _LL, _P),
    "repro_spmv_ell": (_P, _P, _P, _P, _LL, _LL, _LL, _LL, _P),
    "repro_spmv_csr": (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I,
                       _I, _P),
    "repro_trim_runs": (_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _P),
}
# C entry points that return a count, not a CUDA error
_SIZES = {"repro_row_order_scratch": (_LL, _LL),
          "repro_rank_counts_scratch": (_LL, _I, _LL, _I),
          "repro_rank_counts_banded_scratch": (_LL, _LL, _I)}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update((CSRC / s).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path.  The ``ptxas -v`` report of each source (registers,
    shared memory, spills) is kept beside it as ``<lib>.log``."""
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    tmp = BUILD_DIR / f"tmp_{lib.stem}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for s in SOURCES:
        obj = tmp / (s + ".o")
        procs.append((s, obj, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for s, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {s}\n{out}")
        if p.returncode != 0:
            failed.append(s)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [exe, "-shared", "-o", str(tmp / lib.name)]
        + [str(obj) for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (tmp / lib.name).replace(lib)
    Path(str(lib) + ".log").write_text("\n".join(log))
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in _SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` (which launches ``kernel`` on the
    stream passed as its last argument), raise on a non-zero
    ``cudaGetLastError()``, and count the launch."""
    err = getattr(library(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] += 1


def check_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: no kernel for tensors on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")


def stream_of(tensor) -> int:
    """Raw handle of PyTorch's current stream on ``tensor``'s device."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
