"""PyTorch port, the ``pod`` data axis held to ``repro.train.step``.

One JAX subprocess (4 forced host devices) runs the reference on
``jax.make_mesh((2, 2, 1), ("pod", "data", "model"))`` with degrees
``{"pod": (2,), "data": (2,)}``, for the reduced untied
``qwen1.5-0.5b``: ``make_sync_fn`` on dyadic gradients (``salt_shards``)
for ``ring``, ``hier`` and ``sparse`` (fused), and ``sparse`` with r = 2
replicas on the pod axis and the dead set {1}; and one
``make_train_step`` step of ``ring``, ``hier`` and ``sparse``/fused from
the same weights on the launcher's batch stream.  The port runs the same
on ``mesh_ctx(2, pod=2)``: the syncs give the reference's bits (every
partial sum of dyadic values is exact, whatever the order), the steps
agree within rtol 1e-4 (+ 3e-5, the flat mesh's bound in
``tests/test_torch_train.py``).

Port only: the pod mesh equals the flat mesh with the degrees
concatenated bit for bit (``hier``, ``sparse``), (2, 2, 2) equals (4,
2), FSDP (reduced internvl2)
at pod = 2 equals its flat mesh; the ring's per-axis order; the mesh
bookkeeping and the per-axis ``dp_degrees`` validation; the fingerprint
tells a pod mesh from its flat one.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.allreduce import make_device_plan
from repro_torch.core.topology import ButterflyPlan
from repro_torch.core.transport import StackedTransport
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
POD, DATA, BATCH, SEQ = 2, 2, 8, 32
M = POD * DATA
POD_DEGREES = {"pod": (2,), "data": (2,)}
FLAT_DEGREES = {"data": (2, 2)}
HINT = BATCH * SEQ // M
SYNCS = [("ring", "sort", 1, None), ("hier", "sort", 1, None),
         ("sparse", "fused", 1, None), ("sparse", "fused", 2, (1,))]
TRAINS = ["ring", "hier", "sparse"]
# as tests/test_torch_train.py: AdamW's normalized first step turns
# rounding-level gradients into steps of up to lr
ATOL_PARAMS = 3e-5

REFERENCE_CODE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.train import batch_stream
from repro.models import transformer as T
from repro.optim.adamw import AdamW
from repro.train.step import make_sync_fn, make_train_step

inp = np.load(sys.argv[1])
cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                          tie_embeddings=False)
mesh = jax.make_mesh((%(pod)d, %(data)d, 1), ("pod", "data", "model"))

def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]

def unflat(like, prefix=""):
    if isinstance(like, dict):
        return {k: unflat(v, prefix + k + "/") for k, v in like.items()}
    return jnp.asarray(inp["g/" + prefix[:-1]])

params = T.init_params(cfg, 1, seed=0)
out = {}
for p, v in leaves(params):
    out["init/" + "/".join(p)] = np.asarray(v)
grads = unflat(params)
for sync, merge, r, dead in %(syncs)r:
    fn, _ = make_sync_fn(cfg, mesh, sync=sync, dp_degrees=%(degrees)r,
                         sync_merge=merge, replication=r,
                         dead=set(dead) if dead else None,
                         sparse_tokens_hint=%(hint)d)
    synced, ovf = jax.jit(fn)(grads, jnp.asarray(inp["tokens"]))
    tag = f"{sync}_{merge}_{r}"
    for p, v in leaves(synced):
        out[f"sync/{tag}/" + "/".join(p)] = np.asarray(v)
    out[f"ovf/{tag}"] = np.asarray(ovf)
for sync in %(trains)r:
    step, _ = make_train_step(cfg, mesh, sync=sync, dp_degrees=%(degrees)r,
                              sync_merge="fused", sparse_tokens_hint=%(hint)d,
                              donate=False)
    b = {k: jnp.asarray(v) for k, v in
         next(batch_stream(cfg, %(batch)d, %(seq)d, seed=0)).items()}
    p, st, m = step(params, AdamW().init(params), b)
    out[f"loss/{sync}"] = np.asarray(m["loss"])
    for q, v in leaves(p):
        out[f"final/{sync}/" + "/".join(q)] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
""" % {"pod": POD, "data": DATA, "syncs": SYNCS, "degrees": POD_DEGREES,
       "trains": TRAINS, "hint": HINT, "batch": BATCH, "seq": SEQ}


def _cfg(arch="qwen1.5-0.5b", **kw):
    return dataclasses.replace(get_config(arch).reduced(),
                               tie_embeddings=False, **kw)


def _tree(cfg, flat, prefix):
    like = T.init_params(cfg, 1, device="cpu")
    return T.tree_from_leaves(like, [
        (p, torch.as_tensor(np.array(flat[prefix + "/".join(p)])))
        for p, _ in T.tree_leaves(like)])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's arrays (one 4-device subprocess for the file)."""
    d = tmp_path_factory.mktemp("pod_ref")
    cfg = _cfg()
    rng = np.random.RandomState(0)
    like = T.init_params(cfg, 1, device="cpu")
    grads = {"/".join(p): (rng.randint(-64, 65, tuple(t.shape)) / 64.0)
             .astype(np.float32) for p, t in T.tree_leaves(like)}
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    np.savez(d / "in.npz", tokens=tokens,
             **{"g/" + k: v for k, v in grads.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE,
                        str(d / "in.npz"), str(d / "out.npz")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(d / "out.npz") as f:
        out = dict(f)
    return dict(out=out, grads=grads, tokens=tokens, cfg=cfg)


@pytest.mark.parametrize("sync,merge,r,dead", SYNCS)
def test_pod_sync_fn_bits_equal_reference(ref, sync, merge, r, dead):
    """``make_sync_fn`` on the (2, 2) pod mesh: every synced leaf of every
    position and the overflow equal the reference's on its pod mesh, the
    ring (pod first, then data) included, and r = 2 replicas on the pod
    axis with position 1 dead."""
    cfg = ref["cfg"]
    mc = S.mesh_ctx(DATA, pod=POD, device="cpu")
    fn, _ = S.make_sync_fn(cfg, mc, sync=sync, dp_degrees=POD_DEGREES,
                           sync_merge=merge, replication=r,
                           dead=set(dead) if dead else None,
                           sparse_tokens_hint=HINT)
    synced, ovf = fn(_tree(cfg, ref["grads"], ""), ref["tokens"])
    tag = f"{sync}_{merge}_{r}"
    assert int(ovf.max()) == int(ref["out"][f"ovf/{tag}"])
    for path, got in T.tree_leaves(synced):
        want = ref["out"][f"sync/{tag}/" + "/".join(path)]
        assert got.shape[0] == M
        for i in range(M):
            assert np.array_equal(got[i].numpy(), want), (tag, path, i)


@pytest.mark.parametrize("sync", TRAINS)
def test_pod_train_step_tracks_reference(ref, sync):
    """One step on the pod mesh from the reference's weights and batch:
    the loss within rtol 1e-5 and every parameter after the step within
    rtol 1e-4 + 3e-5 of the reference's on its pod mesh."""
    cfg, out = ref["cfg"], ref["out"]
    mc = S.mesh_ctx(DATA, pod=POD, device="cpu")
    step, _ = S.make_train_step(cfg, mc, sync=sync, dp_degrees=POD_DEGREES,
                                sync_merge="fused", sparse_tokens_hint=HINT)
    params = _tree(cfg, out, "init/")
    params, _, m = step(params, AdamW().init(params),
                        next(launch_train.batch_stream(cfg, BATCH, SEQ)))
    np.testing.assert_allclose(float(m["loss"]), out[f"loss/{sync}"],
                               rtol=1e-5)
    for path, got in T.tree_leaves(params):
        np.testing.assert_allclose(
            got.numpy(), out[f"final/{sync}/" + "/".join(path)], rtol=1e-4,
            atol=ATOL_PARAMS, err_msg=str(path))


def _step(cfg, mc, degrees, sync, merge="fused", **kw):
    """One step from seed-0 weights: (loss, row 0 of every synced leaf,
    every parameter after)."""
    step, _ = S.make_train_step(cfg, mc, sync=sync, dp_degrees=degrees,
                                sync_merge=merge, sparse_tokens_hint=HINT,
                                **kw)
    params = T.init_params(cfg, mc.tp, seed=0, device="cpu")
    cap = {}
    params, _, m = step(params, AdamW().init(params),
                        next(launch_train.batch_stream(cfg, BATCH, SEQ)),
                        capture=cap)
    return (float(m["loss"]), [t for _, t in T.tree_leaves(cap["synced"])],
            [t for _, t in T.tree_leaves(params)])


@pytest.mark.parametrize("sync,merge,tp", [
    ("hier", "sort", 1), ("sparse", "fused", 1), ("sparse", "banded", 2)])
def test_pod_mesh_equals_its_flat_mesh(sync, merge, tp):
    """(pod, data, model) = (2, 2, tp) with degrees {pod: (2,), data:
    (2,)} against (4, tp) with {data: (2, 2)}: one logical butterfly, so
    the loss, the synced gradients and the step bit for bit, for ``hier``
    and ``sparse`` (at tp = 2, the sparse sync's hier leaves included)."""
    cfg = _cfg()
    pod = _step(cfg, S.mesh_ctx(DATA, tp, pod=POD, device="cpu"),
                POD_DEGREES, sync, merge)
    flat = _step(cfg, S.mesh_ctx(M, tp, device="cpu"), FLAT_DEGREES, sync,
                 merge)
    assert pod[0] == flat[0]
    assert all(torch.equal(x, y) for x, y in zip(pod[1] + pod[2],
                                                 flat[1] + flat[2]))


def test_fsdp_on_a_pod_mesh_equals_its_flat_mesh():
    """Reduced internvl2 with ``fsdp=True``: the gather and its
    reduce-scatter span both data axes, so the pod mesh's step is the
    flat mesh's bit for bit."""
    cfg = _cfg("internvl2-26b", fsdp=True)
    stream = launch_train.batch_stream(cfg, BATCH, SEQ)
    batch = next(stream)
    out = []
    for mc, degs in ((S.mesh_ctx(DATA, pod=POD, device="cpu"), POD_DEGREES),
                     (S.mesh_ctx(M, device="cpu"), FLAT_DEGREES)):
        ax = mc.axis_ctx(cfg)
        assert ax.fsdp_axes == mc.dp_axes
        assert ax.fsdp_transport.plan.degrees == (M,)
        step, _ = S.make_train_step(cfg, mc, sync="hier", dp_degrees=degs)
        params = T.init_params(cfg, 1, seed=0, device="cpu")
        params, _, m = step(params, AdamW().init(params), batch)
        out.append((float(m["loss"]),
                    [t for _, t in T.tree_leaves(params)]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_replicas_on_the_pod_axis():
    """r = 2 on the pod mesh: the replicas are the pod positions (physical
    i + j * M / r), so a step with a dead replica (1, whose replica is 3)
    equals the step with none, bit for bit, and the replicated butterfly
    plan prepends its
    replica stage to the pod axis, which must divide by r."""
    cfg = _cfg()
    mc = S.mesh_ctx(DATA, pod=POD, device="cpu")
    b = next(launch_train.batch_stream(cfg, BATCH // 2, SEQ))
    tiled = {k: np.tile(v, (2,) + (1,) * (v.ndim - 1)) for k, v in b.items()}
    out = []
    for dead in (None, {1}):
        step, _ = S.make_train_step(cfg, mc, sync="hier",
                                    dp_degrees=POD_DEGREES, replication=2,
                                    dead=dead)
        params = T.init_params(cfg, 1, seed=0, device="cpu")
        params, _, m = step(params, AdamW().init(params), tiled)
        out.append((float(m["loss"]), [t for _, t in T.tree_leaves(params)]))
    for other in out[1:]:
        assert other[0] == out[0][0]
        assert all(torch.equal(a, b) for a, b in zip(other[1], out[0][1]))
    plan = make_device_plan([("pod", 2), ("data", 2)], {"data": (2,)}, 8,
                            8, replication=2)
    assert plan.stages[0].axis_name == "pod" and plan.stages[0].degree == 2
    assert plan.logical.degrees == (2, 2) and plan.replication == 2
    with pytest.raises(ValueError, match="pod=3 not divisible by r=2"):
        make_device_plan([("pod", 3), ("data", 2)], {"data": (2,)}, 8, 8,
                         replication=2)


def test_pod_mesh_bookkeeping_and_degree_validation():
    """``mesh_ctx(data, model, pod)``: M = pod * data, ``dp_axes`` pod
    first, ``shape`` names the pod axis only on a pod mesh; the default
    plan has one round-robin stage per axis, pod first; a degree dict
    naming an axis the mesh lacks, or whose product misses an axis's
    size, raises; pod < 1 raises; the fingerprint tells the meshes
    apart."""
    mc = S.mesh_ctx(2, 2, pod=3, device="cpu")
    assert (mc.dp, mc.tp, mc.dp_axes) == (6, 2, ("pod", "data"))
    assert mc.shape == {"pod": 3, "data": 2, "model": 2}
    assert S.mesh_ctx(6, 2, device="cpu").shape == {"data": 6, "model": 2}
    plan = S.default_dp_plan(mc, 8, 8)
    assert [(st.axis_name, st.degree) for st in plan.stages] == \
        [("pod", 3), ("data", 2)]
    assert plan.logical.degrees == (3, 2)
    with pytest.raises(ValueError, match="not data axes"):
        S.default_dp_plan(mc, 8, 8, {"data": (2,), "model": (2,)})
    with pytest.raises(ValueError, match="axis pod"):
        S.default_dp_plan(mc, 8, 8, {"pod": (2,)})
    with pytest.raises(ValueError, match="axis data"):
        S.default_dp_plan(S.mesh_ctx(2, pod=2, device="cpu"), 8, 8,
                          FLAT_DEGREES)
    with pytest.raises(ValueError, match=">= 1"):
        S.mesh_ctx(2, pod=0, device="cpu")
    cfg = _cfg()
    assert S.train_fingerprint(cfg, mesh=S.mesh_ctx(2, pod=2,
                                                    device="cpu").shape) \
        != S.train_fingerprint(cfg, mesh=S.mesh_ctx(4, device="cpu").shape)


def test_ring_sums_each_data_axis_in_turn():
    """The transport's sum over axes (2, 2) is (x0 + x2) + (x1 + x3):
    over pod, then over data, counted as two sums; over one axis it is
    the whole-mesh tree (x0 + x1) + (x2 + x3)."""
    x = torch.tensor([[1.0], [2.0 ** -24], [-1.0], [2.0 ** -24]])
    tr = StackedTransport(ButterflyPlan(4, (2, 2)), "cpu")
    got = tr.psum(x, axes=(2, 2))
    assert torch.equal(got, ((x[0] + x[2]) + (x[1] + x[3])).expand(4, 1))
    assert tr.sums == 2
    flat = tr.psum(x)
    assert torch.equal(flat, ((x[0] + x[1]) + (x[2] + x[3])).expand(4, 1))
    assert not torch.equal(got, flat) and tr.sums == 3
    with pytest.raises(ValueError, match="axes"):
        tr.psum(x, axes=(3, 2))
