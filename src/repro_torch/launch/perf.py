"""Dry-run studies H1-H4 on the port (reference: ``repro.launch.perf``).

    PYTHONPATH=src python -m repro_torch.launch.perf [--study h1|h2|h3|h4|all] [--out DIR]

Each run traces a production-mesh pair on meta tensors
(``launch.dryrun.run_pair``) and prints its roofline terms; the JSONs go
to ``--out``.

H1: gemma3-12b x train_minibatch, the gradient sync ring -> hier ->
    sparse, tied and untied, and the sparse sync's butterfly at degrees
    16, 4 x 4 and 2 x 2 x 2 x 2.
H2: arctic-480b x train_4k, the microbatch count and the MoE capacity
    factor.
H3: jamba-1.5-large-398b x train_4k, remat policy full -> dots.
H4: the 2D weight-stationary decode against the gather decode on
    command-r-plus-104b, arctic-480b and jamba-1.5-large-398b at
    decode_32k, and command-r and jamba at long_500k (split-KV, with and
    without serve2d).
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import run_pair

UNTIED = {"tie_embeddings": False}
H1 = [("h1_ring_tied", "ring", {}, None),
      ("h1_ring_untied", "ring", UNTIED, None),
      ("h1_hier_untied", "hier", UNTIED, None),
      ("h1_sparse_untied", "sparse", UNTIED, None),
      ("h1_sparse_4x4", "sparse", UNTIED, {"data": (4, 4)}),
      ("h1_sparse_2222", "sparse", UNTIED, {"data": (2, 2, 2, 2)})]
H2 = [("h2_micro8_cap2.0", 8, {}), ("h2_micro4_cap2.0", 4, {}),
      ("h2_micro2_cap2.0", 2, {}),
      ("h2_micro4_cap1.25", 4, {"moe_capacity": 1.25})]
H3 = [("h3_remat_full", {}), ("h3_remat_dots", {"remat_policy": "dots"})]
H4 = [("h4_gather", "command-r-plus-104b", "decode_32k", False),
      ("h4_serve2d", "command-r-plus-104b", "decode_32k", True),
      ("h4_long_gather", "command-r-plus-104b", "long_500k", False),
      ("h4_long_serve2d", "command-r-plus-104b", "long_500k", True),
      ("h4_arctic_gather", "arctic-480b", "decode_32k", False),
      ("h4_arctic_serve2d", "arctic-480b", "decode_32k", True),
      ("h4_jamba_gather", "jamba-1.5-large-398b", "decode_32k", False),
      ("h4_jamba_serve2d", "jamba-1.5-large-398b", "decode_32k", True),
      ("h4_jamba_long_g", "jamba-1.5-large-398b", "long_500k", False),
      ("h4_jamba_long_2d", "jamba-1.5-large-398b", "long_500k", True)]


def _report(tag: str, r: dict) -> None:
    print(f"{tag:24s} coll {r.get('collective_bytes', 0) / 1e9:9.3f} GB  "
          f"flops {r.get('traced_flops', 0):.3g}  t(comp/mem/coll) "
          f"{r.get('t_compute_s', 0):.4f}/{r.get('t_memory_s', 0):.4f}/"
          f"{r.get('t_collective_s', 0):.4f} s  modeled "
          f"{r.get('modeled_memory', {}).get('total', 0):.2f} GB  "
          f"trace {r.get('trace_s', 0):.1f} s", flush=True)


def study(name: str, outdir: str):
    """The runs of one study: ``[(tag, result)]``."""
    runs = []
    if name == "h1":
        runs = [(tag, dict(arch="gemma3-12b", shape="train_minibatch",
                           sync=sync, overrides=ov, dp_degrees=degs))
                for tag, sync, ov, degs in H1]
    elif name == "h2":
        runs = [(tag, dict(arch="arctic-480b", shape="train_4k",
                           microbatch=mb, overrides=ov))
                for tag, mb, ov in H2]
    elif name == "h3":
        runs = [(tag, dict(arch="jamba-1.5-large-398b", shape="train_4k",
                           overrides=ov)) for tag, ov in H3]
    elif name == "h4":
        runs = [(tag, dict(arch=a, shape=s, serve2d=s2d))
                for tag, a, s, s2d in H4]
    out = []
    for tag, kw in runs:
        r = run_pair(kw.pop("arch"), kw.pop("shape"), False,
                     kw.pop("sync", "ring"), outdir, tag_suffix="_" + tag,
                     **kw)
        out.append((tag, r))
        _report(tag, r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--study", default="all",
                    choices=["all", "h1", "h2", "h3", "h4"])
    ap.add_argument("--out", default="results/perf_torch")
    args = ap.parse_args(argv)
    for name in ("h1", "h2", "h3", "h4"):
        if args.study in ("all", name):
            print(f"== {name.upper()} ==")
            study(name, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
