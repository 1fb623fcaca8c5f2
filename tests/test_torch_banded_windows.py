"""PyTorch port, the banded scatter's window table on the CPU.

The CUDA kernel (``csrc/banded_onehot_scatter.cu``) runs only on the card
(``tests/test_torch_gpu.py``); its window table, modelled in plain
PyTorch, is checked here:

* its window table (``ref.banded_windows_ref``, what ``banded_windows``
  runs on CPU tensors) equals the JAX package's own start table, one
  ``jnp.searchsorted(pos, arange(n_tiles) * bm, side="left")`` per batch
  row as in ``repro.kernels.onehot_scatter.banded_onehot_scatter_add``, at
  the port's tile height ``BANDED_ROWS`` and at small ones, with one entry
  more: the end of the last tile's window, ``searchsorted(pos, rows)``;
* the windows are disjoint and adjacent, each holds only its tile's rows,
  and together they cover exactly the kept sources, on random monotone
  ``pos`` with drop-bin tails, leading ``-1`` entries and empty tiles.

Table entries are integers: every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.onehot_scatter import BANDED_ROWS, banded_windows

CASES = ("random", "leading", "empty_tiles", "parked", "dense")


def _pos(kind, seed, bm):
    """([B, C] int32 non-decreasing positions, rows) of one kind, with
    tiles of ``bm`` rows: B = 3 rows of different windows."""
    rng = np.random.RandomState(seed)
    rows = 4 * bm + rng.randint(1, bm)           # no multiple of the tile
    out = []
    for _ in range(3):
        mult = rng.randint(0, 4, rows)
        lead, tail = 0, rng.randint(0, 3 * bm)
        if kind == "leading":
            lead = rng.randint(1, 2 * bm)
        elif kind == "empty_tiles":
            mult[bm:3 * bm] = 0
            mult[-rng.randint(1, bm):] = 0
        elif kind == "parked":
            mult[:] = 0
        elif kind == "dense":
            mult[:] = 1
        pos = np.concatenate([np.full(lead, -1),
                              np.repeat(np.arange(rows), mult),
                              rows + np.arange(tail) // 3])
        out.append(pos)
    c = max(len(p) for p in out) + rng.randint(0, 5)
    return np.stack([np.concatenate([p, np.full(c - len(p), rows)])
                     for p in out]).astype(np.int32), rows


def _table(pos, rows, bm):
    """The plain window table; through ``banded_windows`` at the port's
    tile height (its CPU path)."""
    t = torch.as_tensor(pos)
    if bm == BANDED_ROWS:
        return banded_windows(t, rows).numpy()
    return ref.banded_windows_ref(t, rows, bm).numpy()


@pytest.mark.parametrize("bm", [BANDED_ROWS, 64, 7])
@pytest.mark.parametrize("kind", CASES)
def test_window_table_equals_jax_start_table(kind, bm):
    pos, rows = _pos(kind, seed=len(kind) + bm, bm=bm)
    got = _table(pos, rows, bm)
    n_tiles = -(-rows // bm)
    assert got.shape == (pos.shape[0], n_tiles + 1) and got.dtype == np.int64
    for b in range(pos.shape[0]):
        row = jnp.asarray(pos[b])
        start = jnp.searchsorted(row, jnp.arange(n_tiles, dtype=jnp.int32)
                                 * bm, side="left")
        np.testing.assert_array_equal(got[b, :n_tiles], np.asarray(start))
        assert got[b, n_tiles] == int(jnp.searchsorted(row, rows,
                                                       side="left"))


@pytest.mark.parametrize("bm", [BANDED_ROWS, 64, 7])
@pytest.mark.parametrize("kind", CASES)
def test_windows_partition_the_kept_sources(kind, bm):
    pos, rows = _pos(kind, seed=3 * len(kind) + bm, bm=bm)
    first = _table(pos, rows, bm)
    for b in range(pos.shape[0]):
        p, f = pos[b], first[b]
        assert np.all(np.diff(f) >= 0)           # disjoint, adjacent windows
        covered = np.zeros(len(p), bool)
        for t in range(len(f) - 1):
            win = p[f[t]:f[t + 1]]
            assert np.all((win >= t * bm) & (win < min((t + 1) * bm, rows)))
            covered[f[t]:f[t + 1]] = True
        np.testing.assert_array_equal(covered, (p >= 0) & (p < rows))

