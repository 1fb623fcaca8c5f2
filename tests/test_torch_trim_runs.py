"""PyTorch port, the union path's run compaction on the CPU.

The CUDA kernel (``csrc/trim_runs.cu``) runs only on the card
(``tests/test_torch_gpu.py``); its plain version (``ref.trim_runs_ref``,
what ``trim_runs`` runs on CPU tensors) is the generic compaction the
union path ran before the kernel: a mask of the valid slots, a cumulative
sum for each kept row's place and a scatter, which assumes nothing of the
runs.  It is held here to the runs' valid prefixes laid end to end, as
each layout was built.  The layouts: S = 2, 4 and 64 equal runs, each
sorted with its valid rows first, with empty and full runs, the union
longer than the capacity (rows dropped inside a run), exactly the
capacity, shorter, and every run's offset unaligned; values W = 1 (no
trailing dim), W = 1 as a dim, W = 3 and W = 1,536, float32 and bfloat16,
compared bit for bit.  The wrapper raises on a bad dtype, a bad shape and
slots that are not whole runs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sparse_vec import SENTINEL
from repro_torch.kernels.trim_runs import trim_runs

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

LAYOUTS = ("random", "empty_runs", "full_runs", "over_cap", "exact_cap",
           "unaligned")


def _counts(kind, rng, b, s, l):
    """[b, s] valid rows a run for a layout, and the out capacity."""
    n = rng.randint(0, l + 1, (b, s))
    if kind == "empty_runs":
        n[:, ::2] = 0
        n[0] = 0                     # one chunk with nothing at all
    elif kind == "full_runs":
        n[:] = l
    elif kind == "unaligned":        # odd counts: every later offset odd
        n = 2 * rng.randint(0, (l + 1) // 2, (b, s)) + 1
        n = np.minimum(n, l - (l % 2 == 0))
    tot = n.sum(1)
    if kind == "over_cap":           # the cut lands inside a run
        cap = int(tot.min()) - l // 2 - 1
        return n, max(cap, 1)
    if kind == "exact_cap":
        n[1:] = n[0]
        return n, int(tot[0])
    return n, int(tot.max()) + 5


def _layout(kind, seed, b, s, l, wshape, dtype):
    """(idx [b, s * l], val [b, s * l, *wshape], cap): each run sorted with
    its valid rows first and SENTINEL after, values general floats with
    signed zeros among them and garbage in the padding slots."""
    rng = np.random.RandomState(seed)
    n, cap = _counts(kind, rng, b, s, l)
    idx = np.full((b, s, l), SENTINEL, np.int64)
    for i in range(b):
        for r in range(s):
            ids = np.unique(rng.randint(0, SENTINEL, 2 * l + 8,
                                        dtype=np.int64))
            idx[i, r, :n[i, r]] = np.sort(rng.permutation(ids)[:n[i, r]])
    val = torch.from_numpy(rng.standard_normal((b, s * l) + wshape)
                           .astype(np.float32)).to(dtype)
    val.view(-1)[::7] = -0.0
    return torch.from_numpy(idx.reshape(b, s * l)), val, cap


def _want(idx, val, l, cap):
    """The runs' valid prefixes laid end to end, cut at ``cap``, SENTINEL
    and zero values after them: built run by run from the layout."""
    b, c = idx.shape[0], idx.shape[-1]
    want_idx = torch.full((b, cap), SENTINEL, dtype=torch.int64)
    want_val = torch.zeros((b, cap) + val.shape[2:], dtype=val.dtype)
    for i in range(b):
        keep = torch.cat([torch.arange(r, r + int((idx[i, r:r + l]
                                                   != SENTINEL).sum()))
                          for r in range(0, c, l)])[:cap]
        want_idx[i, :len(keep)] = idx[i, keep]
        want_val[i, :len(keep)] = val[i, keep]
    return want_idx, want_val


def _bits(t):
    """The raw bits of a float tensor, so that -0.0 and 0.0 differ."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("s,l", [(2, 40), (4, 17), (64, 6)])
@pytest.mark.parametrize("wshape", [(), (1,), (3,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_trim_equals_scan_compaction(kind, s, l, wshape, dtype):
    idx, val, cap = _layout(kind, s * 131 + l, 3, s, l, wshape, dtype)
    got_idx, got_val = trim_runs(idx, val, l, cap)
    want_idx, want_val = _want(idx, val, l, cap)
    assert got_idx.shape == (3, cap) and got_val.shape == (3, cap) + wshape
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(_bits(got_val), _bits(want_val))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_trim_at_train_width(dtype):
    """W = 1,536 (the embedding rows the training stack's sparse sync
    carries), two chunks of two runs, the union over the capacity."""
    idx, val, cap = _layout("over_cap", 7, 2, 2, 64, (1536,), dtype)
    got_idx, got_val = trim_runs(idx, val, 64, cap)
    want_idx, want_val = _want(idx, val, 64, cap)
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(_bits(got_val), _bits(want_val))


@pytest.mark.parametrize("cap", [0, 1, 50, 300])
def test_plain_trim_leading_dims_and_capacities(cap):
    """Several leading dims, a capacity of 0, one cut inside the first run
    and one past the gathered slots (all tail)."""
    idx, val, _ = _layout("random", 3, 6, 4, 25, (2,), torch.float32)
    want_idx, want_val = _want(idx, val, 25, cap)
    idx, val = idx.reshape(2, 3, 100), val.reshape(2, 3, 100, 2)
    got_idx, got_val = trim_runs(idx, val, 25, cap)
    want_idx = want_idx.reshape(2, 3, cap)
    want_val = want_val.reshape(2, 3, cap, 2)
    assert got_idx.shape == (2, 3, cap) and got_val.shape == (2, 3, cap, 2)
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(_bits(got_val), _bits(want_val))


def test_trim_runs_on_meta_tensors_gives_shapes():
    """A dry run traces the union path on meta tensors: the wrapper returns
    outputs of the result's shape and dtype there."""
    idx = torch.empty(2, 3, 40, dtype=torch.int64, device="meta")
    val = torch.empty(2, 3, 40, 5, dtype=torch.bfloat16, device="meta")
    got_idx, got_val = trim_runs(idx, val, 10, 24)
    assert got_idx.shape == (2, 3, 24) and got_idx.dtype == torch.int64
    assert got_val.shape == (2, 3, 24, 5) and got_val.dtype == torch.bfloat16
    assert got_idx.device.type == got_val.device.type == "meta"


@pytest.mark.parametrize("bad", ["idx_int32", "val_bool", "val_complex",
                                 "val_rows", "idx_scalar", "runs", "zero_run",
                                 "cap"])
def test_trim_runs_refuses_what_the_kernel_does_not_take(bad):
    idx, val, _ = _layout("random", 1, 2, 4, 8, (), torch.float32)
    run, cap = 8, 10
    err = ValueError
    if bad == "idx_int32":
        idx, err = idx.to(torch.int32), TypeError
    elif bad == "val_bool":
        val, err = val > 0, TypeError
    elif bad == "val_complex":
        val, err = val.to(torch.complex64), TypeError
    elif bad == "val_rows":
        val = val[:, :-1]
    elif bad == "idx_scalar":
        idx = idx[0, 0]
    elif bad == "runs":
        run = 6                      # 32 slots are not whole runs of 6
    elif bad == "zero_run":
        run = 0
    else:
        cap = -1
    with pytest.raises(err):
        trim_runs(idx, val, run, cap)
