"""Production and development meshes (reference: ``repro.launch.mesh``).

The reference's production mesh is 16 x 16 TPU chips a pod (2 pods for
the multi-pod mesh).  The port's is the same (data, model) shape as a
stacked mesh (``train.step.mesh_ctx``), by default on the meta device:
the dry run traces a step there, shapes only, nothing allocated.
"""
from __future__ import annotations

from repro_torch.train.step import MeshCtx, mesh_ctx


def make_production_mesh(multi_pod: bool = False, device="meta") -> MeshCtx:
    """(data, model) = (16, 16); ``multi_pod`` adds a pod axis of 2 (512
    positions)."""
    return mesh_ctx(16, 16, pod=2 if multi_pod else 1, device=device)


def make_dev_mesh(data: int = 1, model: int = 1, device=None) -> MeshCtx:
    """A small mesh for examples and tests (default: the current CUDA
    device)."""
    return mesh_ctx(data, model, device=device)
