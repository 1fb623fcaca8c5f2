"""PyTorch port, the model axis (tp > 1) held to ``repro.models`` and ``repro.train.step``.

The reference runs one program per (data, model) device; the port runs
each data row's model positions on one device, every leaf held whole
and viewed per position only where tp changes the function
(``models.common``).  One
subprocess runs the reference on 4 forced host devices.

(a) Against the reference at tp > 1 (reduced untied configs from the
same weights, float32): qwen1.5-0.5b at (data, model) = (2, 2) and at
(1, 4), where ``n_kv = 2 < tp`` takes the kv slice; granite-moe at (2,
2); internvl2 with FSDP at (2, 2).  The reference differentiates under
``shard_map(check_vma=False)``, where each ``psum`` transposes to a
``psum``; its per-position gradients (``out_specs`` per position) were
measured against the port's first, and they relate to the true ones by
one rule: every model-sharded leaf, ``emb`` and ``head`` holds tp times
its shard of the true gradient; each replicated leaf holds a partial on
each model position, the partials summing to tp times the true gradient
(so for granite's router: of the loss plus 0.01 times the mean of the
positions' aux, the objective the port defines); each FSDP leaf holds
the reduce-scatter over the data axis of tp times the true gradient.
No leaf departed from the rule.  (On reduced jamba at (2, 2), measured
once and not run here, the mamba leaves follow it too, to 1.4e-4 of the
max, the rounding its stack amplifies.)  Held: the loss within rtol
1e-5; every gradient leaf, by the rule, within rtol 1e-4 + 1e-5 x max;
granite's aux of each model position within rtol 1e-5; the per-shard
sparse sync through ``make_sync_fn`` at (2, 2) on dyadic salted values
(the reference's harness salts): every synced leaf of every position bit
for bit, the overflow of each position exact, and each position's union
indices exactly the rows its shard's sync fills.

(b) Against the reference at tp = 1, where the global shapes coincide:
two steps of reduced qwen and of reduced xlstm (cut to one mLSTM and one
sLSTM block) at (2, 1) in the reference and (2, 2) in the port, ``hier``
sync, the parameters after each step within rtol 1e-4 + 1e-5 x max.
AdamW runs with ``eps = 1`` and ``lr = 0.1`` on both sides, so its step
is nearly linear in the gradient: with the default ``eps``, elements
whose gradient lies at rounding level move by +-lr on either side of
zero, which no bound on the parameters could hold.

(c) Port only: the port at tp = 2 equals the port at tp = 1 on the same
global weights for every block kind (dense, sliding window, MoE with a
capacity that drops nothing, mamba, mLSTM / sLSTM, encoder-decoder, VLM
with FSDP), a whole ``hier`` step with the aux weight 0 (the aux of a
token slice is another function than the aux of the row); the model
axis's permutations equal the reference's ``all_to_all`` / tiled
``all_gather``; a sparse sync costs ``2 * depth`` data-axis exchanges
for all columns together; the model-axis exchanges of a forward
are counted; reduced qwen in bfloat16 at (4, 2) against (4, 1) stays in
``chip_smoke.TP_PAIR_LIMITS``, the bound of the card's pair; the
launcher trains with ``--model-axis 2``.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.sparse_vec import SENTINEL
from repro_torch.core.transport import ModelAxis
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models.sharding import full_model_spec_tuples
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as S

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
SEQ = 32
XLSTM_CUT = dict(n_layers=2, pattern=("mlstm", "slstm"),
                 ffn_pattern=("none", "none"))
LINEAR_ADAMW = dict(lr=0.1, eps=1.0)


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(),
                               tie_embeddings=False, **kw)


CASES = {"qwen22": (_cfg("qwen1.5-0.5b"), 2, 2),
         "qwen14": (_cfg("qwen1.5-0.5b"), 1, 4),
         "granite22": (_cfg("granite-moe-3b-a800m"), 2, 2),
         "internvl22": (_cfg("internvl2-26b", fsdp=True), 2, 2)}

REFERENCE_CODE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config
from repro.models import transformer as T
from repro.models.sharding import full_model_pspec
from repro.optim.adamw import AdamW
from repro.train import step as RS

def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]

def rebuild(like, flat):
    def rb(t, prefix=()):
        if isinstance(t, dict):
            return {k: rb(v, prefix + (k,)) for k, v in t.items()}
        return jnp.asarray(flat[prefix])
    return rb(like)

def cfg_of(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(),
                               tie_embeddings=False, **kw)

def batch(cfg, rows, seed):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab, (rows, %(seq)d)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab, (rows, %(seq)d)).astype(np.int32)}
    if cfg.img_tokens:
        b["img_embeds"] = rng.randn(rows, cfg.img_tokens,
                                    cfg.d_model).astype(np.float32)
    return b

out = {}
per_pos = lambda tree: jax.tree.map(lambda _: P("data", "model"), tree)

# (a) each position's loss, aux and gradients at tp > 1
for name, cfg, dp, tp in (
        ("qwen22", cfg_of("qwen1.5-0.5b"), 2, 2),
        ("qwen14", cfg_of("qwen1.5-0.5b"), 1, 4),
        ("granite22", cfg_of("granite-moe-3b-a800m"), 2, 2),
        ("internvl22", cfg_of("internvl2-26b", fsdp=True), 2, 2)):
    mesh = jax.make_mesh((dp, tp), ("data", "model"))
    ax = RS.mesh_ctx(mesh).axis_ctx(cfg)
    params = T.init_params(cfg, tp, seed=0)
    for p, v in leaves(params):
        out[f"{name}/init/" + "/".join(p)] = np.asarray(v)
    b = batch(cfg, 2 * dp, 0)
    keys = sorted(b)
    for k in keys:
        out[f"{name}/batch/{k}"] = b[k]

    def body(p, *bv, ax=ax, cfg=cfg, keys=keys):
        mb = dict(zip(keys, bv))
        def f(p):
            loss, aux = T.forward_loss(p, mb["tokens"], mb["labels"], cfg, ax,
                                       extra_embeds=mb.get("img_embeds"))
            return loss + 0.01 * aux, (loss, aux)
        g, (loss, aux) = jax.grad(f, has_aux=True)(p)
        return (jax.tree.map(lambda x: x[None, None], g), loss[None, None],
                aux[None, None])
    fn = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(full_model_pspec(cfg, tp, ("data",)),) + (P("data"),) * len(keys),
        out_specs=(per_pos(params), P("data", "model"), P("data", "model")),
        check_vma=False))
    g, loss, aux = fn(params, *[jnp.asarray(b[k]) for k in keys])
    out[f"{name}/loss"], out[f"{name}/aux"] = np.asarray(loss), np.asarray(aux)
    for p, v in leaves(g):
        out[f"{name}/grad/" + "/".join(p)] = np.asarray(v)

# the per-shard sparse sync at (2, 2) on dyadic values, salted as the
# reference's make_sync_fn salts
cfg = cfg_of("qwen1.5-0.5b")
mesh = jax.make_mesh((2, 2), ("data", "model"))
mc = RS.mesh_ctx(mesh)
rng = np.random.RandomState(3)
like = T.init_params(cfg, 2, seed=0)
flat = {p: (rng.randint(1, 64, np.shape(v)) / 64.0).astype(np.float32)
        for p, v in leaves(like)}
for p, v in flat.items():
    out["sync/grad/" + "/".join(p)] = v
tokens = (rng.zipf(1.3, (4, %(seq)d)) %% cfg.vocab).astype(np.int32)
out["sync/tokens"] = tokens
hier, sparse, edges = RS._build_sync_plans(cfg, mc, mesh, "sparse",
                                           {"data": (2,)}, %(seq)d, False)

def sbody(g, toks, *edges):
    salt = jnp.exp2(-((lax.axis_index("data") %% 2) %% 4).astype(jnp.float32))
    g = jax.tree.map(lambda x: x * salt, g)
    synced, ovf, _ = RS.sync_grads(g, cfg, mc, "sparse", hier, sparse, edges,
                                   toks, merge="sort")
    return jax.tree.map(lambda x: x[None, None], synced), ovf[None, None]
fn = jax.jit(shard_map(
    sbody, mesh=mesh,
    in_specs=(full_model_pspec(cfg, 2, ("data",)), P("data"))
    + tuple(P("data", None) for _ in edges),
    out_specs=(per_pos(like), P("data", "model")), check_vma=False))
synced, ovf = fn(rebuild(like, flat), jnp.asarray(tokens), *edges)
out["sync/ovf"] = np.asarray(ovf)
for p, v in leaves(synced):
    out["sync/synced/" + "/".join(p)] = np.asarray(v)

# the model axis's all_to_all and tiled all_gather
x = np.arange(2 * 2 * 2 * 3, dtype=np.float32).reshape(2, 2, 2, 3)
for nm, coll in (("a2a", lambda v: lax.all_to_all(v, "model", 0, 0)),
                 ("gather", lambda v: lax.all_gather(v, "model", axis=0,
                                                     tiled=True))):
    fn = jax.jit(shard_map(lambda v, coll=coll: coll(v[0, 0])[None, None],
                           mesh=mesh, in_specs=P("data", "model"),
                           out_specs=P("data", "model"), check_vma=False))
    out["layout/" + nm] = np.asarray(fn(jnp.asarray(x)))
out["layout/x"] = x

# (b) two steps at tp = 1, AdamW nearly linear
for name, cfg in (("qwen_tp1", cfg_of("qwen1.5-0.5b")),
                  ("xlstm_tp1", cfg_of("xlstm-1.3b", **%(xlstm)r))):
    opt = AdamW(**%(adamw)r)
    step, _ = RS.make_train_step(cfg, jax.make_mesh((2, 1), ("data", "model")),
                                 sync="hier", dp_degrees={"data": (2,)},
                                 opt=opt, donate=False)
    p = T.init_params(cfg, 1, seed=0)
    for q, v in leaves(p):
        out[f"{name}/init/" + "/".join(q)] = np.asarray(v)
    st = opt.init(p)
    for i in range(2):
        b = batch(cfg, 4, 10 + i)
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()})
        out[f"{name}/loss{i}"] = np.asarray(m["loss"])
        for q, v in leaves(p):
            out[f"{name}/step{i}/" + "/".join(q)] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
""" % {"seq": SEQ, "xlstm": XLSTM_CUT, "adamw": LINEAR_ADAMW}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's arrays (one 4-device subprocess for the file)."""
    out = tmp_path_factory.mktemp("tp") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


def _tree(ref, prefix, cfg, tp):
    """The port's tree of ``ref``'s arrays under ``prefix``."""
    like = T.init_params(cfg, tp, seed=0, device="cpu")
    return T.tree_from_leaves(like, [
        (p, torch.as_tensor(ref[prefix + "/".join(p)]))
        for p, _ in T.tree_leaves(like)])


def _batch(ref, name, cfg, dp):
    """The case's batch as each data position's rows, [dp, rows, ...]."""
    b = {k: torch.as_tensor(ref[f"{name}/batch/{k}"]) for k in
         ("tokens", "labels", "img_embeds") if f"{name}/batch/{k}" in ref}
    return {k: v.reshape((dp, -1) + tuple(v.shape[1:])) for k, v in b.items()}


def _per_position(g, spec, tp):
    """A data row's global-shape gradient [dp, *global] as each model
    position's shard [dp, tp, *local] (replicated leaves repeated)."""
    if "model" not in spec:
        return g.unsqueeze(1).expand((g.shape[0], tp) + tuple(g.shape[1:]))
    j = 1 + list(spec).index("model")
    return g.unflatten(j, (tp, g.shape[j] // tp)).movedim(j, 1)


def _port_grads(cfg, params, b, dp, tp):
    """The step's differentiation alone at (dp, tp): each data row's
    gradient of its loss plus 0.01 times its positions' mean aux, with
    FSDP leaves held once (their gradient summed over the rows); the
    losses [dp] and aux [dp, tp]."""
    mc = S.mesh_ctx(dp, tp, device="cpu")
    held = S.fsdp_block_paths(cfg)
    leaves = T.tree_leaves(params)
    ps = [t.clone().requires_grad_(True) if p[0] == "blocks" and p[1:] in held
          else t.unsqueeze(0).expand((dp,) + tuple(t.shape)).requires_grad_(
              True) for p, t in leaves]
    tree = T.tree_from_leaves(params, [(p, t) for (p, _), t in zip(leaves, ps)])
    loss, aux = T.forward_loss(tree, b["tokens"].long(), b["labels"].long(),
                               cfg, mc.axis_ctx(cfg),
                               extra_embeds=b.get("img_embeds"))
    gs = torch.autograd.grad((loss + 0.01 * aux.mean(-1)).sum(), ps)
    return [p for p, _ in leaves], gs, loss.detach(), aux.detach()


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_aux_and_gradients_match_reference_at_tp(ref, name):
    """Loss (rtol 1e-5), each model position's aux (rtol 1e-5) and every
    gradient leaf by the rule of the module docstring (rtol 1e-4 + 1e-5 x
    max), the FSDP leaves through the port's own held-once gather."""
    cfg, dp, tp = CASES[name]
    params = _tree(ref, f"{name}/init/", cfg, tp)
    paths, gs, loss, aux = _port_grads(cfg, params, _batch(ref, name, cfg, dp),
                                       dp, tp)
    np.testing.assert_allclose(loss.numpy(), ref[f"{name}/loss"][:, 0],
                               rtol=1e-5)
    assert np.all(ref[f"{name}/loss"] == ref[f"{name}/loss"][:, :1])
    if cfg.n_experts:
        np.testing.assert_allclose(aux.numpy(), ref[f"{name}/aux"], rtol=1e-5)
        assert len(np.unique(ref[f"{name}/aux"])) == dp * tp
    spec = dict(T.tree_leaves(full_model_spec_tuples(cfg, tp)))
    held = S.fsdp_block_paths(cfg)
    for path, g in zip(paths, gs):
        r = ref[f"{name}/grad/" + "/".join(path)]          # [dp, tp, *local]
        s = spec[path]
        if path[0] == "blocks" and path[1:] in held:
            # held once: the rows' sum, its data shards along the fsdp dim
            f = list(s).index("fsdp")
            g = torch.stack(g.chunk(dp, dim=f), 0)
        if "model" in s:
            got, want = _per_position(g, s, tp), r / tp
        else:
            got, want = g, r.sum(1) / tp
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
            err_msg=f"{name} {path}")


@pytest.mark.parametrize("merge", ["sort", "fused", "banded"])
def test_sparse_sync_per_vocab_shard_matches_reference(ref, merge):
    """``make_sync_fn`` at (2, 2), sparse, every merge, on the reference's
    dyadic gradients and token batch: every position's synced leaves bit
    for bit (the embedding per vocab shard, the ``hier`` leaves), the
    overflow of each of the four positions exact, and each position's
    union indices exactly the rows its shard's sync fills; one union
    reduce of 2 x depth exchanges serves both columns."""
    cfg = _cfg("qwen1.5-0.5b")
    mc = S.mesh_ctx(2, 2, device="cpu")
    fn, spec = S.make_sync_fn(cfg, mc, sync="sparse", dp_degrees={"data": (2,)},
                              sync_merge=merge, sparse_tokens_hint=SEQ)
    grads = _tree(ref, "sync/grad/", cfg, 2)
    capture = {}
    synced, ovf = fn(grads, ref["sync/tokens"], capture=capture)
    assert np.array_equal(ovf.numpy(), ref["sync/ovf"].reshape(-1))
    sflat = dict(T.tree_leaves(spec))
    for path, g in T.tree_leaves(synced):
        want = ref["sync/synced/" + "/".join(path)]
        assert np.array_equal(_per_position(g, sflat[path], 2).numpy(), want), \
            path
    idx = capture["emb"]["idx"]                        # [dp * tp, out]
    emb = ref["sync/synced/emb"].reshape(4, -1, cfg.d_model)
    v_l = emb.shape[1]
    for n in range(4):
        row = idx[n][idx[n] != SENTINEL]
        assert torch.equal(row, torch.sort(row).values)
        rows = S._as_int32(S.SYNC_PERM.inv(row)) - (n % 2) * v_l
        filled = np.flatnonzero(np.abs(emb[n]).sum(-1))
        assert np.array_equal(np.sort(rows.numpy()), filled), n


def test_model_axis_layouts_match_reference(ref):
    """``ModelAxis.all_to_all`` of [dp, tp, tp, ...] buffers and the tiled
    ``all_gather`` equal ``lax.all_to_all`` / ``lax.all_gather`` on a (2,
    2) mesh (the gather held once per data row); each counted."""
    axis = ModelAxis(2)
    x = torch.as_tensor(ref["layout/x"])
    assert torch.equal(axis.all_to_all(x), torch.as_tensor(ref["layout/a2a"]))
    got = axis.all_gather(x)
    for m in range(2):
        assert torch.equal(got, torch.as_tensor(ref["layout/gather"][:, m]))
    assert axis.calls == 2


@pytest.mark.parametrize("name,arch,cut", [("qwen_tp1", "qwen1.5-0.5b", {}),
                                           ("xlstm_tp1", "xlstm-1.3b",
                                            XLSTM_CUT)])
def test_tp2_steps_track_reference_at_tp1(ref, name, arch, cut):
    """Two ``hier`` steps at (2, 2) from the reference's tp = 1 weights
    (the same global shapes) track its (2, 1) run: losses within rtol
    1e-5 and the parameters after each step within rtol 1e-4 + 1e-5 x
    max (AdamW nearly linear on both sides, as the docstring says).  For
    xlstm this holds the port's mLSTM and sLSTM at tp = 2 to the tp = 1
    function."""
    cfg = _cfg(arch, **cut)
    params = _tree(ref, f"{name}/init/", cfg, 2)
    opt = AdamW(**LINEAR_ADAMW)
    step, _ = S.make_train_step(cfg, S.mesh_ctx(2, 2, device="cpu"),
                                sync="hier", dp_degrees={"data": (2,)},
                                opt=opt, donate=False)
    st = opt.init(params)
    for i in range(2):
        rng = np.random.RandomState(10 + i)
        b = {k: rng.randint(0, cfg.vocab, (4, SEQ)) for k in ("tokens",
                                                              "labels")}
        params, st, m = step(params, st, b)
        np.testing.assert_allclose(float(m["loss"]), ref[f"{name}/loss{i}"],
                                   rtol=1e-5)
        for path, t in T.tree_leaves(params):
            want = ref[f"{name}/step{i}/" + "/".join(path)]
            np.testing.assert_allclose(
                t.numpy(), want, rtol=1e-4,
                atol=1e-5 * float(np.abs(want).max()), err_msg=f"{i} {path}")


TP_KINDS = {"qwen1.5-0.5b": {}, "gemma3-12b": {},
            "granite-moe-3b-a800m": {"moe_capacity": 8.0},
            "jamba-1.5-large-398b": {"moe_capacity": 8.0},
            "xlstm-1.3b": {}, "whisper-base": {},
            "internvl2-26b": {"fsdp": True}}
# atol multiples of max|leaf|: the SSM test's bound where the stack
# amplifies rounding (xlstm's tp = 2 and tp = 1 gradients part by up to
# 1.7e-4 x max, jamba's by 1.2e-5), 1e-5 elsewhere (at most 2.6e-6)
TP_KIND_ATOL = {"xlstm-1.3b": 1e-3, "jamba-1.5-large-398b": 1e-3}


@pytest.mark.parametrize("arch", sorted(TP_KINDS))
def test_tp2_step_equals_tp1_step_every_block_kind(arch):
    """The same global weights at (2, 1) and (2, 2), one ``hier`` step with
    the aux weight 0: losses within rtol 1e-5 and every synced gradient
    leaf within rtol 1e-4 + ``TP_KIND_ATOL`` x max."""
    cfg = _cfg(arch, **TP_KINDS[arch])
    params = T.init_params(cfg, 1, seed=5, device="cpu")
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(
        T.tree_leaves(params),
        T.tree_leaves(T.init_params(cfg, 2, seed=5, device="cpu"))))
    rng = np.random.RandomState(2)
    batch = {k: rng.randint(0, cfg.vocab, (4, SEQ))
             for k in ("tokens", "labels")}
    if cfg.img_tokens:
        batch["img_embeds"] = rng.randn(4, cfg.img_tokens, cfg.d_model)
    if cfg.enc_layers:
        batch["enc_frames"] = rng.randn(4, cfg.enc_seq, cfg.d_model)
    batch = {k: torch.as_tensor(v.astype(np.float32) if v.dtype == np.float64
                                else v) for k, v in batch.items()}
    out = {}
    for tp in (1, 2):
        step, _ = S.make_train_step(cfg, S.mesh_ctx(2, tp, device="cpu"),
                                    sync="hier", dp_degrees={"data": (2,)},
                                    aux_weight=0.0, donate=False)
        capture = {}
        _, _, m = step(params, AdamW().init(params), batch, capture=capture)
        out[tp] = (float(m["loss"]), T.tree_leaves(capture["synced"]))
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-5)
    for (path, a), (_, b) in zip(out[2][1], out[1][1]):
        atol = TP_KIND_ATOL.get(arch, 1e-5) * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol,
                                   msg=f"{arch} {path}")


def test_exchanges_are_counted_per_axis():
    """A sparse sync at (4, 2) over data degrees (2, 2) costs 2 x depth =
    4 data-axis exchanges for both columns together; a forward's
    model-axis exchanges are the MoE's alone (two dispatch all_to_alls,
    the return, the all_gather), counted: a dense forward has none."""
    cfg = _cfg("qwen1.5-0.5b")
    mc = S.mesh_ctx(4, 2, device="cpu")
    plans = S._build_sync_plans(cfg, mc, "sparse", {"data": (2, 2)}, 16,
                                False)
    g = torch.ones((4, T.padded_vocab(cfg, 2), cfg.d_model))
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab,
                                                           (4, 16)))
    _, ovf, _ = S.sparse_sync_rows(g, ids, mc, plans.sparse_plan,
                                   plans.sparse_edges, plans.sparse,
                                   merge="fused")
    assert plans.sparse.calls == 4 and ovf.shape == (8,)
    for arch, calls in (("qwen1.5-0.5b", 0), ("granite-moe-3b-a800m", 4)):
        cfg = _cfg(arch)
        mc = S.mesh_ctx(2, 2, device="cpu")
        p = T.init_params(cfg, 2, seed=0, device="cpu")
        tree = T.tree_from_leaves(p, [(k, t.unsqueeze(0).expand(
            (2,) + tuple(t.shape))) for k, t in T.tree_leaves(p)])
        toks = torch.zeros((2, 1, 16), dtype=torch.int64)
        with torch.no_grad():
            T.forward_loss(tree, toks, toks, cfg, mc.axis_ctx(cfg))
        assert mc.model_axis.calls == calls


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tp", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bf16_tp_pair_within_the_card_bound():
    """Reduced untied qwen in bfloat16 at (4, 2) against the same weights
    at (4, 1), one ``hier`` step of the card's batch: ``chip_smoke.tp_pair``
    on the CPU, within ``TP_PAIR_LIMITS`` leaf by leaf (the loss, every
    synced gradient leaf and every leaf's update), the key bias alone
    left out by its rule."""
    smoke = _smoke()
    smoke.DEVICE = "cpu"
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", "untied").reduced(),
                              dtype=torch.bfloat16)
    out = smoke.tp_pair(torch, cfg, 4, 2, (2, 2))
    assert out["ok"] and out["left_out"] == ["blocks/b0/attn/bk"]
    assert all(0.0 <= x <= 1.0 for x in out["excess"].values())


def test_tp_pair_holds_each_leaf_to_its_own_max():
    """``chip_smoke.tp_pair_excess`` bounds each leaf by its own max: a
    fault of 5% of a small leaf's max fails the pair though it is 1e-5 of
    the largest leaf's, in the gradient and, where the gradient's sign is
    fixed, in the update; a key bias is left out."""
    smoke = _smoke()
    g = torch.Generator().manual_seed(0)
    paths = [("blocks", "b0", "attn", "bk"), ("final_ln",), ("head",)]
    scale = {"bk": 1e-9, "final_ln": 1e-3, "head": 1e2}
    before = [(p, torch.randn(64, generator=g)) for p in paths]
    grads = [(p, torch.randn(64, generator=g) * scale[p[-1]]) for p in paths]
    after = [(p, t - 1e-3 * torch.sign(gr)) for (p, t), (_, gr)
             in zip(before, grads)]
    b = {"loss": 2.0, "before": before, "synced": grads, "after": after}
    worst, left = smoke.tp_pair_excess(torch, dict(b), b)
    assert left == ["blocks/b0/attn/bk"]
    assert worst["grads"][0] == worst["update"][0] == 0.0
    k = int(torch.argmax(grads[1][1].abs()))
    bad_g = [(p, t.clone()) for p, t in grads]
    bad_g[1][1][k] += 0.05 * float(grads[1][1].abs().max())
    worst, _ = smoke.tp_pair_excess(torch, dict(b, synced=bad_g), b)
    assert worst["grads"][0] > 1.0 and worst["grads"][1] == "final_ln"
    bad_p = [(p, t.clone()) for p, t in after]
    bad_p[1][1][k] += 2e-3 * torch.sign(grads[1][1][k])
    worst, _ = smoke.tp_pair_excess(torch, dict(b, after=bad_p), b)
    assert worst["update"][0] > 1.0 and worst["update"][1] == "final_ln"


def test_launcher_trains_with_a_model_axis(tmp_path, monkeypatch):
    """``--model-axis 2`` trains two steps of reduced untied granite-moe
    with the sparse fused sync; a pod axis composes with the model axis; a
    dim that does not split over tp still raises."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans"))
    loss = launch_train.main(
        ["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
         "--steps", "2", "--batch", "4", "--seq", "16", "--sync", "sparse",
         "--untied", "--merge", "fused", "--data-axis", "2",
         "--model-axis", "2", "--dp-degrees", "2"])
    assert np.isfinite(loss)
    mc = S.mesh_ctx(2, 2, pod=2, device="cpu")
    assert (mc.dp, mc.tp, mc.shape) == (4, 2, {"pod": 2, "data": 2,
                                                "model": 2})
    with pytest.raises(ValueError, match="does not split d_ff 512"):
        S.make_train_step(_cfg("qwen1.5-0.5b"), S.mesh_ctx(1, 3, device="cpu"))
