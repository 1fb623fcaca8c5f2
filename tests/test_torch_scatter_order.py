"""PyTorch port, the dense scatter's counting layout (``row_order``).

The CUDA ``onehot_scatter_add`` sorts its sources stably by destination
(radix passes over the destination's digits), then sums each row's
contiguous run in order.  On the CPU, ``row_order`` runs its plain version
(a stable ``argsort`` plus ``bincount`` / ``cumsum``), which must equal a
numpy stable argsort on random, all-one-row, all-dropped and drop-bin
inputs, with leading batch dims.  Summing each row's run of that layout in
order, one float32 add at a time, must give the plain scatter's bits on
general floats -- the claim the kernel's summation order rests on -- and
the plain scatter stays within rtol 1e-6 of the JAX reference's
``onehot_scatter_add_ref`` (which adds in its own order).  The kernel
itself is held to these on the card by ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.ref import onehot_scatter_add_ref as j_scatter_ref

from repro_torch.kernels import ref
from repro_torch.kernels.onehot_scatter import onehot_scatter_add, row_order

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)


def _pos(rng, kind, shape, rows):
    if kind == "random":
        return rng.randint(-1, rows + 2, shape)
    if kind == "one_row":
        return np.full(shape, rows // 3)
    if kind == "dropped":
        return rng.choice([-1, rows, rows + 7], shape)
    # "drop_bin": dense destinations with a tail parked at num_rows, as the
    # merge's compaction hands them
    p = rng.randint(0, rows, shape)
    p[..., -(shape[-1] // 4):] = rows
    return p


def _numpy_order(pos, rows):
    key = np.where((pos < 0) | (pos >= rows), rows, pos).reshape(
        -1, pos.shape[-1])
    perm = np.argsort(key, axis=-1, kind="stable")
    counts = np.stack([np.bincount(k, minlength=rows + 1) for k in key])
    off = np.concatenate([np.zeros((len(key), 1), np.int64),
                          np.cumsum(counts, -1)[:, :-1]], -1)
    return (perm.reshape(pos.shape),
            off.reshape(pos.shape[:-1] + (rows + 1,)))


@pytest.mark.parametrize("kind", ["random", "one_row", "dropped", "drop_bin"])
@pytest.mark.parametrize("shape,rows", [((3, 700), 50), ((2, 3, 257), 1000),
                                        ((1, 1), 1)])
def test_row_order_plain_equals_numpy_stable_argsort(kind, shape, rows):
    rng = np.random.RandomState(len(kind) + rows)
    pos = _pos(rng, kind, shape, rows).astype(np.int32)
    perm, off = row_order(torch.as_tensor(pos), rows)
    want_perm, want_off = _numpy_order(pos, rows)
    assert perm.dtype == off.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(off.numpy(), want_off)
    with pytest.raises(TypeError, match="int32"):
        row_order(torch.as_tensor(pos.astype(np.int64)), rows)


def _sum_through_layout(perm, off, src, rows):
    """out[b, p] = 0.f + src[b, perm[off[p]]] + ... in float32, one add at
    a time: the kernel's per-row summation."""
    b = src.shape[0]
    out = np.zeros((b, rows, src.shape[-1]), np.float32)
    for g in range(b):
        for p in range(rows):
            acc = np.zeros(src.shape[-1], np.float32)
            for j in range(off[g, p], off[g, p + 1]):
                acc = (acc + src[g, perm[g, j]]).astype(np.float32)
            out[g, p] = acc
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["random", "one_row", "drop_bin"])
def test_layout_sum_equals_plain_scatter_bits(dtype, kind):
    rng = np.random.RandomState(7)
    b, c, w, rows = 2, 600, 2, 40
    pos = torch.as_tensor(_pos(rng, kind, (b, c), rows).astype(np.int32))
    scale = None
    if dtype == "int8":
        val = torch.as_tensor(rng.randint(-127, 128, (b, c, w))
                              .astype(np.int8))
        scale = torch.as_tensor(rng.rand(b, c).astype(np.float32))
        src = val.numpy().astype(np.float32) * scale.numpy()[..., None]
    else:
        val = torch.as_tensor(rng.randn(b, c, w).astype(np.float32)).to(
            getattr(torch, dtype))
        src = val.float().numpy()
    got = onehot_scatter_add(pos, val, rows, scale=scale)
    perm, off = row_order(pos, rows)
    np.testing.assert_array_equal(
        got.numpy(), _sum_through_layout(perm.numpy(), off.numpy(),
                                         src.astype(np.float32), rows))
    want = np.stack([np.asarray(j_scatter_ref(
        np.where(pos[g].numpy() < 0, rows, pos[g].numpy()), src[g], rows))
        for g in range(b)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, ref.onehot_scatter_add_ref(pos, val, rows, scale))
