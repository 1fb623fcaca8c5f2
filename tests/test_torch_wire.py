"""PyTorch port, wire codecs: ``repro_torch.kernels.wirecodec`` and the
union path's ``wire=`` knob held to the JAX package.

In-process: packed index words equal the reference's bit for bit at
widths 1-32 (through ``.view(np.uint32)``), int8 quantization gives the
same q and scale, and the static plan metadata (index widths, group
strides, payload bytes) is the same on the same plans.  One JAX
subprocess (8 forced host devices) runs the reference's
``run_union_allreduce(merge="sort")`` for the four wires at degrees
(4, 2), (2, 4) and (8,) -- the reference's fused and banded merges equal
its sort merge on dyadic inputs (tests/test_banded_merge.py), and
interpret-mode Pallas inside shard_map would not fit the test budget --
and the port runs the same inputs on the CPU under all three merges:
indices and overflow exact, values bit for bit for raw, delta and
delta+bf16 (dyadic inputs), and within 1e-5 x max|union| of the
reference's own int8 output for delta+int8ef.  Plus the API's guards.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.allreduce import make_device_plan as jmake_plan
from repro.kernels import wirecodec as jwc

from repro_torch.core.allreduce import make_device_plan, run_union_allreduce
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.sparse_vec import HashPerm
from repro_torch.core.transport import StackedTransport
from repro_torch.kernels import wirecodec as wc

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SENT = 0xFFFFFFFF
M, C, R = 8, 64, 4096
DEGREES = [(4, 2), (2, 4), (8,)]
WIRES = ["raw", "delta", "delta+bf16", "delta+int8ef"]
MERGES = ["sort", "fused", "banded"]
_ENV = dict(os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src")
            + os.pathsep + os.environ.get("PYTHONPATH", ""))

REFERENCE_CODE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.allreduce import make_device_plan, run_union_allreduce

inp = np.load(sys.argv[1])
out = {}
mesh = jax.make_mesh((8,), ("d",))
for degs in %(degrees)r:
    tag = "x".join(map(str, degs))
    plan = make_device_plan([("d", 8)], {"d": degs}, in_capacity=64,
                            out_capacity=8 * 64)
    for wire in %(wires)r:
        fn = jax.jit(lambda i, v, plan=plan, wire=wire: run_union_allreduce(
            mesh, plan, i, v, merge="sort", wire=wire))
        oi, ov, ovf = fn(jnp.asarray(inp["idx"]), jnp.asarray(inp["val"]))
        key = f"{tag}_{wire}"
        out[key + "_idx"] = np.asarray(oi)
        out[key + "_val"] = np.asarray(ov)
        out[key + "_ovf"] = np.asarray(ovf)
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
""" % {"degrees": DEGREES, "wires": WIRES}


def _union_inputs():
    """[M, C] hashed sorted unique indices with dyadic values (multiples of
    1/256 below 8: every f32 partial sum is exact, in any order)."""
    rng = np.random.RandomState(4)
    perm = HashPerm.make(9)
    idx = np.full((M, C), SENT, np.uint32)
    val = np.zeros((M, C), np.float32)
    for n in range(M):
        nn = rng.randint(10, C - 4)
        h = perm.fwd_np(rng.choice(R, size=nn, replace=False).astype(np.uint32))
        order = np.argsort(h)
        idx[n, :nn] = h[order]
        val[n, :nn] = rng.randint(-2048, 2048, nn)[order] / 256.0
    return idx, val


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's union outputs for every (degrees, wire), from one
    8-device JAX subprocess."""
    d = tmp_path_factory.mktemp("ref_wire")
    idx, val = _union_inputs()
    np.savez(d / "in.npz", idx=idx, val=val)
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(d / "in.npz"),
                        str(d / "out.npz")], env=_ENV, capture_output=True,
                       text=True, timeout=560)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# union path, every (degrees, wire, merge)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("degs", DEGREES)
def test_union_wire_matches_reference_8dev(reference, degs, wire, merge):
    idx, val = _union_inputs()
    key = f"{'x'.join(map(str, degs))}_{wire}"
    plan = make_device_plan([("d", M)], {"d": degs}, in_capacity=C,
                            out_capacity=M * C)
    oi, ov, ovf = run_union_allreduce(plan, torch.as_tensor(idx.astype(np.int64)),
                                      torch.as_tensor(val), merge=merge,
                                      wire=wire)
    np.testing.assert_array_equal(oi.numpy().astype(np.uint32),
                                  reference[key + "_idx"])
    np.testing.assert_array_equal(ovf.numpy(), reference[key + "_ovf"])
    assert ov.dtype == torch.float32
    want = reference[key + "_val"]
    if wire == "delta+int8ef":
        amax = float(np.abs(want).max())
        np.testing.assert_allclose(ov.numpy(), want, rtol=0, atol=1e-5 * amax)
    else:
        np.testing.assert_array_equal(ov.numpy(), want)
    if wire == "delta":          # lossless: equal to raw bit for bit
        np.testing.assert_array_equal(want, reference[key[:-5] + "raw_val"])


def test_union_wire_costs_two_depth_exchanges():
    """Words, values and int8 scales of one exchange travel together."""
    idx, val = _union_inputs()
    plan = make_device_plan([("d", M)], {"d": (2, 2, 2)}, C, M * C)
    tr = StackedTransport(plan.logical, "cpu")
    run_union_allreduce(plan, torch.as_tensor(idx.astype(np.int64)),
                        torch.as_tensor(val), merge="banded",
                        wire="delta+int8ef", transport=tr)
    assert tr.calls == 6


@pytest.mark.parametrize("degs", [(2, 4), (4, 2), (2, 2, 2)])
def test_transport_position_is_the_reference_digit(degs):
    """The receiver's group position equals the reference's
    ``(axis_index // stride) % degree``; strides differ between (2, 4)
    and (4, 2)."""
    plan = make_device_plan([("d", M)], {"d": degs}, C, M * C)
    tr = StackedTransport(plan.logical, "cpu")
    strides = wc.stage_strides(plan)
    for l, st in enumerate(plan.stages):
        want = (np.arange(M) // strides[l]) % st.degree
        np.testing.assert_array_equal(tr.position(l).numpy(), want)


# ---------------------------------------------------------------------------
# codecs and static metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 7, 13, 28, 31, 32])
def test_pack_indices_words_match_reference(width):
    rng = np.random.RandomState(width)
    r, cap = 4, 37
    base = rng.randint(0, 2 ** 31, size=r).astype(np.uint32)
    span = (1 << width) - 1                     # marker value is reserved
    offs = rng.randint(0, max(span, 1), size=(r, cap)).astype(np.uint64)
    idx = (base[:, None].astype(np.uint64) + offs).astype(np.uint32)
    idx.sort(axis=1)
    idx = np.where(rng.rand(r, cap) < 0.3, np.uint32(SENT), idx)
    want = np.asarray(jwc.pack_indices(jnp.asarray(idx), jnp.asarray(base),
                                       width))
    t_idx = torch.as_tensor(idx.astype(np.int64))
    t_base = torch.as_tensor(base.astype(np.int64))
    words = wc.pack_indices(t_idx, t_base, width)
    assert words.dtype == torch.int32
    assert words.shape == (r, wc.index_words(cap, width))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    back = wc.unpack_indices(words, t_base, cap, width)
    np.testing.assert_array_equal(back.numpy(), idx.astype(np.int64))
    np.testing.assert_array_equal(
        back.numpy().astype(np.uint32),
        np.asarray(jwc.unpack_indices(jnp.asarray(want), jnp.asarray(base),
                                      cap, width)))


@pytest.mark.parametrize("shape", [(5, 33), (4, 7, 3), (6,)])
def test_quant8_rows_match_reference(shape):
    rng = np.random.RandomState(len(shape))
    val = (rng.randn(*shape) * 100.0).astype(np.float32)
    val[1] = 0.0                              # all-zero row: scale clamp
    jq, js = jwc.quant8_rows(jnp.asarray(val))
    q, s = wc.quant8_rows(torch.as_tensor(val))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(wc.dequant8_rows(q, s).numpy(),
                                  np.asarray(jwc.dequant8_rows(jq, js)))
    halves = torch.tensor([[0.5, 1.5, 2.5, -0.5, 127.0]])   # ties to even
    np.testing.assert_array_equal(
        wc.quant8_rows(halves)[0].numpy(),
        np.asarray(jwc.quant8_rows(jnp.asarray(halves.numpy()))[0]))


@pytest.mark.parametrize("degs", [(4, 2), (2, 4), (8,), (2, 2, 2)])
def test_plan_metadata_matches_reference(degs):
    plan = make_device_plan([("d", M)], {"d": degs}, C, M * C)
    jplan = jmake_plan([("d", M)], {"d": degs}, C, M * C)
    assert wc.stage_index_bits(plan) == jwc.stage_index_bits(jplan)
    assert wc.stage_strides(plan) == jwc.stage_strides(jplan)
    for wire in WIRES:
        for cap, bits, width in ((100, 13, 1), (37, 32, 3), (1, 1, 2)):
            assert wc.encoded_payload_bytes(wire, cap, bits, width) == \
                jwc.encoded_payload_bytes(wire, cap, bits, width)
    assert wc.LOSSY_WIRE == jwc.LOSSY_WIRE


# ---------------------------------------------------------------------------
# API
# ---------------------------------------------------------------------------

def test_api_union_reduce_honours_merge_and_wire():
    idx, val = _union_inputs()
    out = {}
    for merge in MERGES:
        ar = SparseAllreduce(M, (2, 4), backend="device", device="cpu",
                             merge=merge, wire="delta+bf16")
        out[merge] = ar.union_reduce(idx, val, M * C)
    for merge in ("fused", "banded"):
        assert all(torch.equal(a, b) for a, b in zip(out["sort"], out[merge]))


def test_api_wire_guards():
    with pytest.raises(ValueError, match="wire"):
        SparseAllreduce(4, (4,), backend="sim", wire="zstd")
    with pytest.raises(ValueError, match="merge"):
        SparseAllreduce(4, (4,), backend="sim", merge="radix")
    for wire in wc.LOSSY_WIRE:
        with pytest.raises(NotImplementedError, match="sim"):
            SparseAllreduce(4, (4,), backend="sim", wire=wire)
    SparseAllreduce(4, (4,), backend="sim", wire="delta")     # accepted
    rng = np.random.RandomState(0)
    out_idx = [rng.randint(0, 100, 20).astype(np.uint32) for _ in range(4)]
    in_idx = [rng.choice(100, 10, replace=False).astype(np.uint32)
              for _ in range(4)]
    for wire in wc.LOSSY_WIRE:
        ar = SparseAllreduce(4, (4,), backend="device", device="cpu",
                             wire=wire)
        with pytest.raises(NotImplementedError, match="planned"):
            ar.config(out_idx, in_idx)
    ar = SparseAllreduce(4, (4,), backend="device", device="cpu", wire="delta")
    ar.config(out_idx, in_idx)                                  # accepted
    vals = [np.ones(20, np.float32) for _ in range(4)]
    assert len(ar.reduce(vals)) == 4
