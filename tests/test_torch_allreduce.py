"""PyTorch port, allreduce layer: the stacked-mesh union and planned paths
held to the JAX package's 8-device shard_map paths.

One JAX subprocess per file (8 forced host devices, as in
tests/test_device_allreduce.py) runs the reference's
``run_union_allreduce(merge="sort")`` and planned ``make_reduce_fn`` on
inputs this test writes; the port runs the same inputs on its CPU
stacked mesh with ``merge="sort"`` and ``merge="fused"``.  Indices and
overflow must match exactly and values bit for bit (dyadic inputs, so
every partial sum is exact whatever the order).  In-process: the
carry-across of a reference plan-cache artifact, the transport's
collective semantics and exchange count, and the API's guards.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.allreduce import make_device_plan as jmake_plan
from repro.core.autotune import planned_to_artifact
from repro.core.planned import plan_sparse_allreduce as jplan
from repro.core.sparse_vec import HashPerm as JHashPerm

from repro_torch.core.allreduce import make_device_plan, run_union_allreduce
from repro_torch.core.api import SparseAllreduce
from repro_torch.core.planned import (plan_sparse_allreduce,
                                      planned_from_reference)
from repro_torch.core.simulator import dense_oracle
from repro_torch.core.sparse_vec import HashPerm
from repro_torch.core.topology import ButterflyPlan
from repro_torch.core.transport import StackedTransport

M, C, R = 8, 64, 4096
UNION_DEGREES = [(4, 2), (2, 2, 2), (8,), (2, 4)]
PLANNED_DEGREES = [(4, 2), (8,)]
_ENV = dict(os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src")
            + os.pathsep + os.environ.get("PYTHONPATH", ""))

REFERENCE_CODE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.allreduce import make_device_plan, run_union_allreduce
from repro.core.planned import plan_sparse_allreduce
from repro.core.sparse_vec import HashPerm

inp = np.load(sys.argv[1])
out = {}
mesh = jax.make_mesh((8,), ("d",))
for degs in %(union)r:
    tag = "x".join(map(str, degs))
    for name, cap in (("full", 8 * 64), ("small", 64)):
        for w in ("val", "val2"):
            plan = make_device_plan([("d", 8)], {"d": degs}, in_capacity=64,
                                    out_capacity=cap)
            fn = jax.jit(lambda i, v, plan=plan: run_union_allreduce(
                mesh, plan, i, v))
            oi, ov, ovf = fn(jnp.asarray(inp["idx"]), jnp.asarray(inp[w]))
            out[f"u_{tag}_{name}_{w}_idx"] = np.asarray(oi)
            out[f"u_{tag}_{name}_{w}_val"] = np.asarray(ov)
            out[f"u_{tag}_{name}_{w}_ovf"] = np.asarray(ovf)
n = int(inp["n_planned"])
out_idx = [inp[f"p_out{i}"] for i in range(n)]
in_idx = [inp[f"p_in{i}"] for i in range(n)]
for degs in %(planned)r:
    tag = "x".join(map(str, degs))
    dplan = make_device_plan([("d", 8)], {"d": degs}, 128, 1024)
    p = plan_sparse_allreduce(dplan, out_idx, in_idx, perm=HashPerm.make(11))
    out[f"p_{tag}"] = np.asarray(p.make_reduce_fn(mesh)(
        jnp.asarray(inp[f"p_vals_{p.u_cap}"])))
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
""" % {"union": UNION_DEGREES, "planned": PLANNED_DEGREES}


def _union_inputs():
    rng = np.random.RandomState(1)
    perm = HashPerm.make(7)
    idx = np.full((M, C), 0xFFFFFFFF, np.uint32)
    val = np.zeros((M, C), np.float32)
    val2 = np.zeros((M, C, 2), np.float32)
    for n in range(M):
        nn = rng.randint(10, C // 2)
        oi = rng.choice(R, size=nn, replace=False).astype(np.uint32)
        h = perm.fwd_np(oi)
        order = np.argsort(h)
        idx[n, :nn] = h[order]
        val[n, :nn] = rng.randint(-2048, 2048, nn)[order] / 256.0
        val2[n, :nn] = rng.randint(-2048, 2048, (nn, 2))[order] / 256.0
    return idx, val, val2


def _planned_inputs():
    rng = np.random.RandomState(3)
    out_idx = [rng.randint(0, 3000, rng.randint(30, 120)).astype(np.uint32)
               for _ in range(M)]
    out_val = [(rng.randint(-1024, 1024, len(o)) / 128.0).astype(np.float32)
               for o in out_idx]
    in_idx = [rng.choice(3000, rng.randint(20, 90), replace=False)
              .astype(np.uint32) for _ in range(M)]
    return out_idx, out_val, in_idx


def _stage(values, u_cap):
    out = np.zeros((len(values), u_cap), np.float32)
    for n, v in enumerate(values):
        out[n, : len(v)] = v
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs on this file's inputs, from one 8-device
    JAX subprocess."""
    d = tmp_path_factory.mktemp("ref_allreduce")
    idx, val, val2 = _union_inputs()
    out_idx, out_val, in_idx = _planned_inputs()
    inp = {"idx": idx, "val": val, "val2": val2, "n_planned": M}
    for i in range(M):
        inp[f"p_out{i}"], inp[f"p_in{i}"] = out_idx[i], in_idx[i]
    u_cap = max(len(o) for o in out_idx)
    inp[f"p_vals_{u_cap}"] = _stage(out_val, u_cap)
    np.savez(d / "in.npz", **inp)
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(d / "in.npz"),
                        str(d / "out.npz")], env=_ENV, capture_output=True,
                       text=True, timeout=560)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("merge", ["sort", "fused"])
@pytest.mark.parametrize("degs", UNION_DEGREES)
def test_union_matches_reference_8dev(reference, degs, merge):
    """Full union and an overflowing capacity, scalar and W=2 values:
    idx and overflow exact, values bit for bit."""
    idx, val, val2 = _union_inputs()
    tag = "x".join(map(str, degs))
    ti = torch.as_tensor(idx.astype(np.int64))
    for name, cap in (("full", M * C), ("small", 64)):
        plan = make_device_plan([("d", M)], {"d": degs}, in_capacity=C,
                                out_capacity=cap)
        for w, v in (("val", val), ("val2", val2)):
            oi, ov, ovf = run_union_allreduce(plan, ti, torch.as_tensor(v),
                                              merge=merge)
            key = f"u_{tag}_{name}_{w}"
            np.testing.assert_array_equal(oi.numpy().astype(np.uint32),
                                          reference[key + "_idx"])
            np.testing.assert_array_equal(ov.numpy(), reference[key + "_val"])
            np.testing.assert_array_equal(ovf.numpy(), reference[key + "_ovf"])
    assert reference[f"u_{tag}_small_val_ovf"].sum() > 0   # overflow exercised


@pytest.mark.parametrize("degs", PLANNED_DEGREES)
def test_planned_reduce_matches_reference_8dev(reference, degs):
    out_idx, out_val, in_idx = _planned_inputs()
    dplan = make_device_plan([("d", M)], {"d": degs}, 128, 1024)
    p = plan_sparse_allreduce(dplan, out_idx, in_idx, perm=HashPerm.make(11))
    got = p.make_reduce_fn("cpu")(torch.as_tensor(_stage(out_val, p.u_cap)))
    np.testing.assert_array_equal(got.numpy(),
                                  reference["p_" + "x".join(map(str, degs))])
    oracle = dense_oracle(out_idx, out_val, in_idx, HashPerm.make(11))
    for n in range(M):
        np.testing.assert_allclose(got[n, : len(in_idx[n])].numpy(), oracle[n],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("degs", [(4, 2), (2, 2, 2)])
def test_planned_from_reference_artifact(degs):
    """A plan frozen by the reference (its plan-cache artifact) runs
    unchanged in the port and reduces identically to the port's own."""
    out_idx, out_val, in_idx = _planned_inputs()
    jd = jmake_plan([("d", M)], {"d": degs}, 128, 1024)
    arrays, meta = planned_to_artifact(
        jplan(jd, out_idx, in_idx, perm=JHashPerm.make(11)))
    carried = planned_from_reference(arrays, meta, {"d": degs}, device="cpu")
    own = plan_sparse_allreduce(make_device_plan([("d", M)], {"d": degs},
                                                 128, 1024),
                                out_idx, in_idx, perm=HashPerm.make(11))
    assert carried.u_cap == own.u_cap and carried.depth == own.depth
    vals = torch.as_tensor(_stage(out_val, own.u_cap))
    a = carried.make_reduce_fn("cpu")(vals)
    b = own.make_reduce_fn("cpu")(vals)
    assert torch.equal(a, b)
    down = own.reduce_down_on_device(vals, own.device_args("cpu"))
    assert down.shape == (M, own.q_cap)
    assert torch.equal(own.reduce_up_on_device(down), b)


@pytest.mark.parametrize("m,degs", [(8, (4, 2)), (12, (3, 2, 2)), (6, (6,))])
def test_transport_is_the_group_collective(m, degs):
    """all_to_all: node n at group position j receives row j of member t
    as its row t; tiled all_gather concatenates the members' rows."""
    plan = ButterflyPlan(m, degs)
    tr = StackedTransport(plan, "cpu")
    for l, k in enumerate(degs):
        x = torch.arange(m * k * 3).reshape(m, k, 3)
        (got,) = tr.all_to_all(l, x)
        (gat,) = tr.all_gather(l, x[:, 0])
        for n in range(m):
            members = plan.group_members(n, l)
            j = members.index(n)
            for t, mem in enumerate(members):
                assert torch.equal(got[n, t], x[mem, j])
            assert torch.equal(gat[n], torch.cat([x[mem, 0] for mem in members]))
    assert tr.calls == 2 * len(degs)


def test_each_reduce_costs_two_depth_exchanges():
    out_idx, out_val, in_idx = _planned_inputs()
    dplan = make_device_plan([("d", M)], {"d": (2, 2, 2)}, 128, 1024)
    p = plan_sparse_allreduce(dplan, out_idx, in_idx)
    routing = p.device_args("cpu")
    before = routing.transport.calls
    p.reduce_on_device(torch.as_tensor(_stage(out_val, p.u_cap)), routing)
    assert routing.transport.calls - before == 2 * p.depth == 6
    idx, val, _ = _union_inputs()
    uplan = make_device_plan([("d", M)], {"d": (4, 2)}, C, M * C)
    tr = StackedTransport(uplan.logical, "cpu")
    run_union_allreduce(uplan, torch.as_tensor(idx.astype(np.int64)),
                        torch.as_tensor(val), merge="fused", transport=tr)
    assert tr.calls == 4


def test_api_device_backend_matches_sim():
    out_idx, out_val, in_idx = _planned_inputs()
    dev = SparseAllreduce(M, (4, 2), backend="device", device="cpu", seed=2)
    sim = SparseAllreduce(M, (4, 2), backend="sim", seed=2)
    assert dev.config(out_idx, in_idx).config_time_s == \
        sim.config(out_idx, in_idx).config_time_s
    for got, want in zip(dev.reduce(out_val), sim.reduce(out_val)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    meta = dev.staging_metadata()
    assert meta["in_lens"] == [len(i) for i in in_idx]
    planned, device = dev.planned_parts()
    assert device.type == "cpu" and planned.uin_cap == meta["uin_cap"]
    assert sim.stats is not None and dev.stats is None
    with pytest.raises(ValueError):
        dev.reduce([v[:-1] for v in out_val])


def test_api_union_reduce_and_plan_cache_counts():
    idx, val, _ = _union_inputs()
    ar = SparseAllreduce(M, (2, 4), backend="device", device="cpu",
                         merge="fused")
    a = ar.union_reduce(idx, val, M * C)
    b = ar.union_reduce(torch.as_tensor(idx.astype(np.int64)),
                        torch.as_tensor(val), M * C)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert ar.union_plan_stats == {"hits": 1, "misses": 1}
    with pytest.raises(ValueError):
        ar.union_reduce(idx[:4], val[:4], M * C)


def test_api_sim_backend_keeps_replication():
    out_idx, out_val, in_idx = _planned_inputs()
    ar = SparseAllreduce(M, (4, 2), replication=2, dead={1, 10}, seed=4)
    ar.config(out_idx, in_idx)
    oracle = dense_oracle(out_idx, out_val, in_idx, ar.perm)
    for got, want in zip(ar.reduce(out_val), oracle):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kwargs,item", [
    ({"plan_cache": True}, "item 10"), ({"retune": True}, "item 10"),
    ({"backend": "device", "replication": 2, "merge": "banded",
      "plan_cache": True}, "item 10"),
    ({"backend": "device", "dead": {1}, "wire": "delta+int8ef",
      "retune": True}, "item 10"),
    ({"backend": "device", "replication": 2, "retune": True}, "item 10"),
    ({"backend": "device", "dead": {1}, "plan_cache": True}, "item 10")])
def test_api_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        SparseAllreduce(M, (4, 2), device="cpu", **kwargs)


def test_api_auto_degrees_resolve_through_tune():
    from repro_torch.core.topology import tune
    ar = SparseAllreduce(64, "auto", expected_nnz=1e5, index_range=1e6)
    assert ar.degrees_source == "tuned"
    assert ar.plan.degrees == tune(64, 1e5, 1e6).degrees
