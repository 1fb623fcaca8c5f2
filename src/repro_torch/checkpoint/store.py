"""Checkpointing: flat-namespace .npz store with tree round trip (reference: ``repro.checkpoint.store``).

The same on-disk format as the reference, so each package reads the
other's artifacts: a tree (dicts, lists, tuples of arrays or tensors) is
flattened to ``name -> ndarray`` (``a/b`` for dict keys, ``#i`` for
sequence items) and written as ``<path>.npz``, then an optional
``<path>.meta.json`` sidecar.  Tensors are written through
``.cpu().numpy()`` (bfloat16 widened to float32, exactly, since numpy
has no bfloat16); :func:`load` given tensors in ``like`` returns tensors
of ``like``'s dtype on its device.

Crash safety: :func:`save` is **atomic** -- each file is written to a
tempfile in the target directory, fsynced, then ``os.replace``d over the
final name, so a kill mid-save never leaves a partial artifact (the
previous complete one survives).  The ``.npz`` is replaced *before* its
sidecar, so a visible meta always describes a complete payload (the plan
cache, ``repro_torch.core.autotune``, relies on that order).  Artifacts
damaged by other means surface as :class:`CheckpointError`, which the
soak harness (``repro_torch.launch.soak``) uses to skip a bad checkpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint artifact exists but cannot be decoded (truncated,
    corrupt, or not a :func:`save` product); distinct from
    ``FileNotFoundError`` so a caller can fall back to an older one."""


def to_numpy(x) -> np.ndarray:
    """An array or tensor (any device) as a host ndarray; a bfloat16
    tensor comes back as float32 (every bfloat16 value is a float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = to_numpy(tree)
    return out


def _atomic_write(final_path: str, write_fn) -> None:
    """Write via tempfile-in-target-dir + fsync + ``os.replace``."""
    d = os.path.dirname(final_path) or "."
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=os.path.basename(final_path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final_path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _base(path: str) -> str:
    return path[: -len(".npz")] if path.endswith(".npz") else path


def save(path: str, tree: Any, meta: Optional[Dict[str, Any]] = None) -> None:
    """Atomically persist ``tree`` at ``path``: ``<path>.npz``, then
    ``<path>.meta.json`` when ``meta`` is given (module docstring)."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base = _base(path)
    # the store's one raw writer: into a tempfile, then os.replace
    _atomic_write(base + ".npz", lambda f: np.savez(f, **flat))  # noqa: RA502
    if meta is not None:
        payload = json.dumps(meta, indent=2, default=str).encode()
        _atomic_write(base + ".meta.json", lambda f: f.write(payload))


def load_flat(path: str) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, Any]]]:
    """``(arrays, meta)`` of a :func:`save` artifact: the flat ``name ->
    ndarray`` mapping and the sidecar dict (``None`` without one).
    Raises ``FileNotFoundError`` when no artifact exists and
    :class:`CheckpointError` when one exists but is corrupt."""
    base = _base(path)
    if not os.path.exists(base + ".npz"):
        raise FileNotFoundError(f"no checkpoint at {base}.npz")
    try:
        with np.load(base + ".npz") as data:
            arrays = {k: data[k] for k in data.files}
    except Exception as e:
        raise CheckpointError(
            f"corrupt or truncated checkpoint {base}.npz "
            f"({type(e).__name__}: {e}); it is not a complete "
            f"checkpoint store artifact") from e
    meta = None
    if os.path.exists(base + ".meta.json"):
        try:
            with open(base + ".meta.json") as f:
                meta = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise CheckpointError(
                f"corrupt checkpoint sidecar {base}.meta.json "
                f"({type(e).__name__}: {e})") from e
    return arrays, meta


def load(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes checked): numpy
    leaves come back as arrays, tensor leaves as tensors on their
    device.  Raises :class:`CheckpointError` on a corrupt artifact."""
    arrays, _ = load_flat(path)

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(rebuild(v, f"{prefix}#{i}/")
                              for i, v in enumerate(tree))
        arr = arrays[prefix[:-1]]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{prefix[:-1]}: stored shape {arr.shape} != "
                             f"{tuple(tree.shape)}")
        if isinstance(tree, torch.Tensor):
            return torch.as_tensor(arr, device=tree.device).to(tree.dtype)
        return arr
    return rebuild(like)


def list_checkpoints(directory: str, prefix: str = "ckpt-"
                     ) -> List[Tuple[int, str]]:
    """Step-numbered artifacts ``<prefix><step>.npz`` in ``directory``,
    newest first, as ``[(step, extension-less base path), ...]``
    (existence only: pair with :func:`load_flat` and catch
    :class:`CheckpointError`)."""
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not (name.startswith(prefix) and name.endswith(".npz")):
            continue
        stem = name[len(prefix):-len(".npz")]
        if stem.isdigit():
            out.append((int(stem), os.path.join(directory, name[:-4])))
    return sorted(out, reverse=True)


def latest_checkpoint(directory: str, prefix: str = "ckpt-"
                      ) -> Optional[Tuple[int, str]]:
    """Newest ``(step, base path)`` per :func:`list_checkpoints`, or
    ``None``."""
    cks = list_checkpoints(directory, prefix)
    return cks[0] if cks else None
