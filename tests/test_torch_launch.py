"""PyTorch port, the launch tooling (``repro_torch.launch``: mesh, specs, memmodel, trace_stats, dryrun, roofline) held to ``repro.launch``'s (ROADMAP Queue 1 item 15).

* ``modeled_memory`` equals the reference's, every part, to rtol 1e-12,
  for all 76 applicable (arch, shape, mesh) pairs of the two production
  meshes (16 x 16 and 2 x 16 x 16): one JAX subprocess with 512 forced
  host devices runs the reference's (about 13 s);
* the per-exchange byte formulas equal ``repro.launch.hlo_stats``'s on
  ``tests/test_hlo_stats.py``'s HLO lines, and the exchange census of
  the same collectives on a stacked mesh of 4 positions gives the
  reference's per-device bytes;
* a dry run of reduced qwen1.5-0.5b's train (``train_minibatch``),
  prefill, decode and long-context decode steps on a (4, 2) meta mesh
  returns every key, ``model_flops_per_chip`` equal to the reference's
  formula (flops factor x the reference config's active parameters x
  tokens / chips), and the roofline table renders from its JSONs.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis.auditor import ExchangeCensus
from repro_torch.configs import (ARCHS, ASSIGNED_SHAPES, SHAPES, get_config,
                                 pair_plan)
from repro_torch.core.topology import ButterflyPlan
from repro_torch.core.transport import StackedTransport
from repro_torch.launch import roofline
from repro_torch.launch import trace_stats as TS
from repro_torch.launch.dryrun import analyse, lower_pair
from repro_torch.launch.memmodel import modeled_memory
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train.step import mesh_ctx

# one intra-op thread a test process: pytest-xdist runs several workers
# at once, and their OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

REFERENCE_CODE = r"""
import json, os, sys
from repro.configs import ARCHS, ASSIGNED_SHAPES, SHAPES, get_config, pair_plan
from repro.launch.memmodel import modeled_memory
from repro.launch.mesh import make_production_mesh
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for a in ARCHS:
        for s in ASSIGNED_SHAPES:
            v = pair_plan(a, s)
            if v is None:
                continue
            out[f"{a}/{s}/{int(mp)}"] = {
                k: float(x) for k, x in
                modeled_memory(get_config(a, v), SHAPES[s], mesh).items()}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref_memory(tmp_path_factory):
    """The reference's modeled memory of every applicable pair."""
    out = tmp_path_factory.mktemp("launch") / "mem.json"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", REFERENCE_CODE, str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_modeled_memory_equals_reference(ref_memory, multi_pod):
    """Every part of every applicable pair, to rtol 1e-12; 38 pairs a
    mesh, 76 in all."""
    mc = make_production_mesh(multi_pod=multi_pod)
    assert mc.device.type == "meta" and mc.dp * mc.tp == 256 * (
        2 if multi_pod else 1)
    n = 0
    for a in ARCHS:
        for s in ASSIGNED_SHAPES:
            v = pair_plan(a, s)
            if v is None:
                continue
            want = ref_memory[f"{a}/{s}/{int(multi_pod)}"]
            got = modeled_memory(get_config(a, v), SHAPES[s], mc)
            assert set(got) == set(want), (a, s)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-12), (a, s, k)
            n += 1
    assert n == 38


def test_byte_formulas_equal_hlo_stats():
    """``moved_bytes`` on each line of ``tests/test_hlo_stats.py``'s HLO
    (kind, result bytes, group size read as the reference reads them)
    equals the reference's ``_line_bytes``; the census of the same
    collectives on 4 stacked positions gives the reference's bytes."""
    sys.path.insert(0, os.path.dirname(__file__))
    from repro.launch import hlo_stats as H
    import test_hlo_stats as cases
    for line in cases.HLO.splitlines():
        want = H._line_bytes(line)
        if want is None:
            continue
        kind, moved = want
        m = H._KIND_RE.search(line)
        size = H._shape_bytes(line[line.index("=") + 1:m.start()])
        g = H._GROUPS_RE.search(line)
        gi = H._GROUPS_IOTA_RE.search(line)
        k = len(g.group(1).split(",")) if g else \
            (int(gi.group(2)) if gi else 1)
        assert TS.moved_bytes(kind, size, k) == moved, line
    tr = StackedTransport(ButterflyPlan(4, (4,)), "cpu")
    with ExchangeCensus() as ex:
        tr.psum(torch.zeros(4, 64))
        tr.all_gather(0, torch.zeros(4, 16))
        tr.reduce_scatter(0, torch.zeros(4, 64))
        tr.all_to_all(0, torch.zeros(4, 4, 16))
    got = TS.collective_stats(ex.records)
    want = H.collective_stats(cases.HLO)
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
        assert got[kind] == {"count": 1, "bytes": want[kind]["bytes"]}, kind
    assert TS.moved_bytes("collective-permute", 256, 2) == \
        want["collective-permute"]["bytes"]


KEYS = {"variant", "tokens", "flops_factor", "active_params",
        "total_params", "n_periods", "microbatch", "serve2d", "chips",
        "trace_s", "mesh", "modeled_memory", "fits_hbm", "traced_flops",
        "traced_matmul_flops", "unfused_op_bytes", "aten_ops",
        "collectives", "collective_bytes", "exchanges", "t_compute_s",
        "t_memory_s", "t_collective_s", "bottleneck",
        "model_flops_per_chip", "useful_compute_ratio"}


def test_dry_run_reduced_qwen_on_meta_mesh(tmp_path):
    """Train, prefill, decode and long-context decode of reduced qwen on
    a (4, 2) meta mesh: every key, the reference's model FLOPs, sane
    terms, and the roofline table."""
    from repro.configs import get_config as ref_config
    mc = mesh_ctx(4, 2, device="meta")
    cfg = get_config("qwen1.5-0.5b").reduced()
    active = ref_config("qwen1.5-0.5b").reduced().active_param_count()
    for shape in ("train_minibatch", "prefill_32k", "decode_32k",
                  "long_500k"):
        run, c, meta = lower_pair("qwen1.5-0.5b", shape, mc, cfg=cfg)
        r = analyse(run, c, meta, mc)
        assert KEYS <= set(r), KEYS - set(r)
        sh = SHAPES[shape]
        tokens = sh.global_batch * (1 if sh.kind.startswith("decode")
                                    else sh.seq_len)
        factor = 6.0 if sh.kind == "train" else 2.0
        assert r["model_flops_per_chip"] == pytest.approx(
            factor * active * tokens / 8, rel=1e-12)
        assert r["traced_flops"] >= r["traced_matmul_flops"] > 0
        assert r["unfused_op_bytes"] > 0 and r["fits_hbm"]
        assert r["bottleneck"] in ("compute", "memory", "collective")
        if sh.kind == "train":
            assert r["exchanges"]["data"]["psum"] > 0   # the ring sync
        if sh.kind == "decode_long":    # split-KV over the data positions
            assert r["exchanges"]["data"] == {"pmax": 1, "psum": 2}
    out = tmp_path / "dry"
    out.mkdir()
    for shape in ("decode_32k", "long_500k"):
        run, c, meta = lower_pair("qwen1.5-0.5b", shape, mc, cfg=cfg)
        d = dict(analyse(run, c, meta, mc), arch="qwen1.5-0.5b", shape=shape)
        (out / f"qwen1.5-0.5b_{shape}_4x2_ring.json").write_text(
            json.dumps(d, default=str))
    text = roofline.table(roofline.load_results(str(out), "4x2"), "4x2")
    assert "| qwen1.5-0.5b | decode_32k |" in text and "not run" in text
    assert np.isfinite(float(text.split("| qwen1.5-0.5b | decode_32k | ")[1]
                             .split(" |")[0]))


def test_dry_run_sparse_sync_on_meta_mesh():
    """The sparse gradient sync traces on meta tensors: untied reduced
    qwen's train_minibatch on a (4, 2) meta mesh returns every key, and
    the exchanges of one train step traced on meta equal, kind by kind
    and layer by layer, those of the same step run on CPU tensors of
    the same shapes (a small batch of seeded Zipf ids)."""
    import dataclasses
    from repro_torch.configs import InputShape
    from repro_torch.launch.specs import (opt_specs, params_specs,
                                          train_batch_specs)
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              tie_embeddings=False)
    mc = mesh_ctx(4, 2, device="meta")
    run, c, meta = lower_pair("qwen1.5-0.5b", "train_minibatch", mc,
                              sync="sparse", cfg=cfg)
    r = analyse(run, c, meta, mc)
    assert KEYS <= set(r), KEYS - set(r)
    assert r["exchanges"]["data"]["all_to_all"] > 0     # the union's layers
    shape = InputShape("small", 16, 8, "train")
    batch = train_batch_specs(cfg, shape)
    census = {}
    for dev in ("meta", "cpu"):
        m = mesh_ctx(4, 2, device=dev)
        step, _ = make_train_step(cfg, m, sync="sparse", microbatch=1)
        if dev == "meta":
            params = params_specs(cfg, m.tp)
            opt = opt_specs(cfg, m.tp, params)
        else:
            params = T.init_params(cfg, m.tp, seed=0, device="cpu")
            opt = AdamW().init(params)
        with ExchangeCensus() as ex:
            step(params, opt, batch)
        census[dev] = [{k: e[k] for k in ("kind", "axis", "layer", "bytes",
                                          "group")} for e in ex.records]
    assert census["meta"] == census["cpu"]
    assert any(e["kind"] == "all_to_all" for e in census["cpu"])


def test_tooling_import_leaves_jax_unloaded():
    """The audits, the dry run and the studies import neither jax nor the
    reference package."""
    code = ("import sys; import repro_torch.analysis, "
            "repro_torch.analysis.cli, repro_torch.launch.dryrun, "
            "repro_torch.launch.perf, repro_torch.launch.roofline, "
            "repro_torch.models.serve2d; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); print('NOJAX')")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "NOJAX" in r.stdout, r.stderr
