"""PyTorch port, the training stack held to ``repro.train.step``.

One JAX subprocess (8 forced host devices, a data x model = 8 x 1 mesh)
runs the reference on inputs this test writes, for the reduced untied
``qwen1.5-0.5b``: ``make_sync_fn`` (``salt_shards``, dyadic gradients)
for ``ring``, ``hier`` (4, 2) and ``sparse`` x {sort, fused, banded},
each plain and with r = 2 and the survivable dead set {1, 6}; and three
``make_train_step`` steps of ``hier`` and ``sparse``/fused from the same
weights on the launcher's batch stream.  The port runs the same on its
CPU stacked mesh: the sync gives the reference's bits (every partial sum
of dyadic values is exact) with all M rows equal; the trajectories agree
within rtol 1e-4.  Port-only: ``delta`` bit-identical to ``raw``,
``microbatch=2`` tracking one pass, the
``delta+int8ef`` carry equal to the residual of its own quantization,
the dense butterflies and the transport's reduce-scatter against a
float64 sum, the launcher on the CPU, its guards, and a subprocess
importing every new module without ``jax``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.allreduce import (dense_allreduce_binary,
                                        dense_allreduce_hierarchical,
                                        dense_allreduce_ring,
                                        make_device_plan)
from repro_torch.core.topology import ButterflyPlan
from repro_torch.core.transport import StackedTransport
from repro_torch.kernels.wirecodec import dequant8_rows, quant8_rows
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as S

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
_ENV = dict(os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            JAX_PLATFORMS="cpu",
            PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
M, BATCH, SEQ, STEPS = 8, 8, 32, 3
DEGREES = {"data": (4, 2)}
SYNCS = [("ring", "sort"), ("hier", "sort"), ("sparse", "sort"),
         ("sparse", "fused"), ("sparse", "banded")]
REPL = [(1, None), (2, (1, 6))]
TRAINS = [("hier", "sort"), ("sparse", "fused")]
# AdamW's normalized step turns gradients at rounding level into steps of
# up to lr (3e-4): the key bias's gradient is mostly cancellation (a bias
# on every key shifts a query's scores by one constant up to rope's
# rotation), so its last bits differ between the packages and its
# parameters by a few percent of lr after three steps
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
mesh = jax.make_mesh((8, 1), ("data", "model"))
params = T.init_params(cfg, 1, seed=0)
flat = lambda tree: {"/".join(p): np.asarray(v) for p, v in
                     T_leaves(tree)}

def T_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(T_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]

def unflat(like, prefix=""):
    if isinstance(like, dict):
        return {k: unflat(v, prefix + k + "/") for k, v in like.items()}
    return jnp.asarray(inp["g/" + prefix[:-1]])

out = {}
for k, v in flat(params).items():
    out["init/" + k] = v
grads = unflat(params)
for sync, merge in %(syncs)r:
    for r, dead in %(repl)r:
        fn, _ = make_sync_fn(cfg, mesh, sync=sync, dp_degrees=%(degrees)r,
                             sync_merge=merge, replication=r,
                             dead=set(dead) if dead else None,
                             sparse_tokens_hint=%(hint)d)
        synced, ovf = jax.jit(fn)(grads, jnp.asarray(inp["tokens"]))
        tag = f"{sync}_{merge}_{r}"
        for k, v in flat(synced).items():
            out[f"sync/{tag}/{k}"] = v
        out[f"ovf/{tag}"] = np.asarray(ovf)
for sync, merge in %(trains)r:
    step, _ = make_train_step(cfg, mesh, sync=sync, dp_degrees=%(degrees)r,
                              sync_merge=merge, sparse_tokens_hint=%(hint)d,
                              donate=False)
    p, st = params, AdamW().init(params)
    stream = batch_stream(cfg, %(batch)d, %(seq)d, seed=0)
    losses = []
    for i in range(%(steps)d):
        b = {k: jnp.asarray(v) for k, v in next(stream).items()}
        p, st, m = step(p, st, b)
        losses.append(float(m["loss"]))
        out[f"ovf_train/{sync}_{merge}/{i}"] = np.asarray(m["sync_overflow"])
    out[f"losses/{sync}_{merge}"] = np.asarray(losses)
    for k, v in flat(p).items():
        out[f"final/{sync}_{merge}/{k}"] = v
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
""" % {"syncs": SYNCS, "repl": REPL, "degrees": DEGREES, "trains": TRAINS,
       "hint": BATCH * SEQ // M, "batch": BATCH, "seq": SEQ, "steps": STEPS}


def _cfg():
    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               tie_embeddings=False)


def _dyadic_grads(cfg):
    """One gradient per leaf, values k / 64 with |k| <= 64."""
    rng = np.random.RandomState(0)
    shapes = dict(T.tree_leaves(T.init_params(cfg, 1, device="cpu")))
    return {"/".join(p): (rng.randint(-64, 65, tuple(t.shape)) / 64.0)
            .astype(np.float32) for p, t in shapes.items()}


def _tree(cfg, flat, prefix=""):
    like = T.init_params(cfg, 1, device="cpu")
    return T.tree_from_leaves(like, [
        (p, torch.as_tensor(np.array(flat[prefix + "/".join(p)])))
        for p, _ in T.tree_leaves(like)])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_ref")
    cfg = _cfg()
    grads = _dyadic_grads(cfg)
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    np.savez(d / "in.npz", tokens=tokens,
             **{"g/" + k: v for k, v in grads.items()})
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE,
                        str(d / "in.npz"), str(d / "out.npz")],
                       env=_ENV, capture_output=True, text=True, timeout=400)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(d / "out.npz") as f:
        out = dict(f)
    return dict(out=out, grads=grads, tokens=tokens, cfg=cfg)


@pytest.mark.parametrize("sync,merge", SYNCS)
@pytest.mark.parametrize("r,dead", REPL)
def test_sync_fn_bits_equal_reference(ref, sync, merge, r, dead):
    cfg = ref["cfg"]
    mc = S.mesh_ctx(M, device="cpu")
    fn, _ = S.make_sync_fn(cfg, mc, sync=sync, dp_degrees=DEGREES,
                           sync_merge=merge, replication=r,
                           dead=set(dead) if dead else None,
                           sparse_tokens_hint=BATCH * SEQ // M)
    synced, ovf = fn(_tree(cfg, ref["grads"]), ref["tokens"])
    tag = f"{sync}_{merge}_{r}"
    assert int(ovf[0]) == int(ref["out"][f"ovf/{tag}"])
    for path, got in T.tree_leaves(synced):
        assert got.shape[0] == M
        assert all(torch.equal(got[0], got[i]) for i in range(1, M)), path
        want = ref["out"][f"sync/{tag}/" + "/".join(path)]
        assert np.array_equal(got[0].numpy(), want), (tag, path)


@pytest.mark.parametrize("sync,merge", TRAINS)
def test_three_train_steps_track_reference(ref, sync, merge):
    cfg = ref["cfg"]
    out = ref["out"]
    mc = S.mesh_ctx(M, device="cpu")
    step, _ = S.make_train_step(cfg, mc, sync=sync, dp_degrees=DEGREES,
                                sync_merge=merge,
                                sparse_tokens_hint=BATCH * SEQ // M)
    params = _tree(cfg, out, "init/")
    st = AdamW().init(params)
    stream = launch_train.batch_stream(cfg, BATCH, SEQ, seed=0)
    losses = []
    for i in range(STEPS):
        params, st, m = step(params, st, next(stream))
        losses.append(float(m["loss"]))
        assert int(m["sync_overflow"]) == int(
            out[f"ovf_train/{sync}_{merge}/{i}"])
    np.testing.assert_allclose(losses, out[f"losses/{sync}_{merge}"],
                               rtol=1e-4)
    for path, got in T.tree_leaves(params):
        np.testing.assert_allclose(
            got.numpy(), out[f"final/{sync}_{merge}/" + "/".join(path)],
            rtol=1e-4, atol=ATOL_PARAMS, err_msg=str(path))


def _steps(cfg, mc, n=2, batch=BATCH, **kw):
    step, _ = S.make_train_step(cfg, mc, dp_degrees=DEGREES,
                                sparse_tokens_hint=batch * SEQ // M, **kw)
    params = T.init_params(cfg, 1, seed=3, device="cpu")
    st = AdamW().init(params)
    stream = launch_train.batch_stream(cfg, batch, SEQ, seed=2)
    losses = []
    for _ in range(n):
        params, st, m = step(params, st, next(stream))
        losses.append(float(m["loss"]))
    return params, st, losses


def test_microbatch_accumulates_in_float32():
    """``microbatch=2`` sums two half-batch gradients in float32 and
    divides, as the reference's scan does: the same trajectory as one
    pass within float rounding."""
    cfg, mc = _cfg(), S.mesh_ctx(M, device="cpu")
    pa, _, la = _steps(cfg, mc, batch=16, sync="hier")
    pb, _, lb = _steps(cfg, mc, batch=16, sync="hier", microbatch=2)
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    for (path, a), (_, b) in zip(T.tree_leaves(pa), T.tree_leaves(pb)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=ATOL_PARAMS, err_msg=str(path))


@pytest.mark.parametrize("merge", ["sort", "fused", "banded"])
def test_delta_wire_bit_identical_to_raw(merge):
    cfg, mc = _cfg(), S.mesh_ctx(M, device="cpu")
    pa, _, la = _steps(cfg, mc, sync="sparse", sync_merge=merge)
    pb, _, lb = _steps(cfg, mc, sync="sparse", sync_merge=merge,
                       sync_wire="delta")
    assert la == lb
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(T.tree_leaves(pa), T.tree_leaves(pb)))


def test_int8ef_carries_its_quantization_residual():
    cfg, mc = _cfg(), S.mesh_ctx(M, device="cpu")
    _, st, losses = _steps(cfg, mc, n=1, sync="sparse", sync_merge="fused",
                           sync_wire="delta+int8ef")
    assert sorted(st) == ["adamw", "ef"] and int(st["adamw"].step) == 1
    vp = T.padded_vocab(cfg, 1)
    assert st["ef"].shape == (M, vp, cfg.d_model)
    assert float(st["ef"].abs().max()) > 0 and np.isfinite(losses).all()
    # the carry is the residual of one int8 quantization of the sent rows
    rng = np.random.RandomState(4)
    grad = torch.as_tensor(rng.randn(M, 64, 8).astype(np.float32))
    ef = torch.as_tensor(rng.randn(M, 64, 8).astype(np.float32)) * 0.01
    ids = torch.as_tensor(rng.randint(0, 40, (M, 12)))
    dplan = make_device_plan([("data", M)], DEGREES, 16, 64)
    tr = StackedTransport(dplan.logical, "cpu")
    _, _, new_ef = S.sparse_sync_rows(grad, ids, mc, dplan,
                                      dplan.edges_tensors("cpu"), tr,
                                      wire="delta+int8ef", ef=ef)
    for n in range(M):
        rows = np.unique(ids[n].numpy())
        sent = grad[n, rows] + ef[n, rows]
        q, s = quant8_rows(sent)
        assert torch.equal(new_ef[n, rows], sent - dequant8_rows(q, s))
        rest = np.setdiff1d(np.arange(64), rows)
        assert torch.equal(new_ef[n, rest], ef[n, rest])


@pytest.mark.parametrize("degrees", [(4, 2), (2, 2, 2), (8,)])
def test_dense_butterflies_sum_every_row(degrees):
    rng = np.random.RandomState(6)
    x = torch.as_tensor(rng.randint(-50, 50, (M, 24)).astype(np.float32))
    want = x.sum(0, keepdim=True).expand(M, -1)
    plan = make_device_plan([("data", M)], {"data": degrees}, 8, 8)
    tr = StackedTransport(plan.logical, "cpu")
    assert torch.equal(dense_allreduce_hierarchical(x, plan, tr), want)
    assert tr.calls == 2 * len(degrees)
    assert torch.equal(dense_allreduce_ring(x, tr), want) and tr.sums == 1
    assert torch.equal(dense_allreduce_binary(x, M), want)
    # reduce_scatter: node n at position j holds its group's chunk j
    tr = StackedTransport(ButterflyPlan(M, degrees), "cpu")
    k = degrees[0]
    got = tr.reduce_scatter(0, x)
    for n in range(M):
        members = tr.plan.group_members(n, 0)
        j = members.index(n)
        chunk = x[members].sum(0)[j * 24 // k:(j + 1) * 24 // k]
        assert torch.equal(got[n], chunk)
    with pytest.raises(ValueError, match="divisible"):
        tr.reduce_scatter(0, x[:, :23])


@pytest.mark.parametrize("degrees", [(4, 2), (2, 2, 2), (8,)])
def test_hier_leaf_blocks_give_one_pass_bits(degrees, monkeypatch):
    """The dense sync of a leaf in column blocks (``HIER_BLOCK``) equals
    one pass of the butterfly over the whole padded leaf bit for bit, on
    bfloat16 values of a wide dynamic range, its float32 row 0 too."""
    plan = make_device_plan([("data", M)], {"data": degrees}, 8, 8)
    tr = StackedTransport(plan.logical, "cpu")
    gen = torch.Generator().manual_seed(5)
    g = (torch.randn(M, 301, 7, generator=gen)
         * torch.exp(3 * torch.randn(M, 301, 7, generator=gen))
         ).to(torch.bfloat16)
    flat = g.to(torch.float32).reshape(M, -1)
    want = dense_allreduce_hierarchical(
        torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % M)), plan,
        tr)[:, :flat.shape[1]]
    for block in (S.HIER_BLOCK, 8 * M * M, M * M):
        monkeypatch.setattr(S, "HIER_BLOCK", block)
        cap = {}
        got = S._hier_allreduce_leaf(g, plan, tr, capture=cap)
        assert torch.equal(got, want.reshape(g.shape).to(torch.bfloat16))
        assert torch.equal(cap["f32"], want[0].reshape(301, 7))


def test_launcher_runs_on_cpu_and_guards(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    loss = launch_train.main(
        ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "8",
         "--seq", "16", "--sync", "sparse", "--untied", "--merge", "fused",
         "--ckpt", str(tmp_path / "ck")])
    assert np.isfinite(loss) and (tmp_path / "ck.npz").exists()
    loss = launch_train.main(
        ["--reduced", "--device", "cpu", "--steps", "1", "--batch", "4",
         "--seq", "16", "--sync", "hier", "--data-axis", "4",
         "--replication", "2", "--dead", "0", "--dp-degrees", "2,2"])
    assert np.isfinite(loss)
    loss = launch_train.main(
        ["--reduced", "--device", "cpu", "--steps", "1", "--batch", "8",
         "--seq", "16", "--sync", "hier", "--sync-overlap", "bucketed"])
    assert np.isfinite(loss)
    mc = S.mesh_ctx(8, pod=2, device="cpu")
    assert (mc.dp, mc.dp_axes) == (16, ("pod", "data"))
    with pytest.raises(ValueError, match="sparse sync"):
        S.make_train_step(_cfg(), S.mesh_ctx(8, device="cpu"), sync="hier",
                          sync_wire="delta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.mesh_ctx(8)


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "import repro_torch.configs, repro_torch.models.transformer\n"
            "import repro_torch.models.moe, repro_torch.models.ssm\n"
            "import repro_torch.optim.adamw, repro_torch.train.step\n"
            "import repro_torch.launch.train, repro_torch.launch.soak\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules), 'repro imported'\n"
            "print('CLEAN')\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr
