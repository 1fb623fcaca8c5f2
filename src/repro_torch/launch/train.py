"""Training launcher (reference: ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --untied --sync sparse --merge fused --data-axis 8 --dp-degrees 4,2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --untied --sync sparse --merge fused --data-axis 2 --model-axis 2
    PYTHONPATH=src python -m repro_torch.launch.train --untied --sync hier \\
        --data-axis 8 --dp-degrees 4,2 --sync-overlap bucketed

Stacks ``--data-axis`` data positions, each with ``--model-axis``
model positions, on one device (the port's mesh,
``repro_torch.train.step.mesh_ctx``; the weights are the global leaves
at that tp), streams the reference's synthetic
Zipf batches (:func:`batch_stream`, byte for byte), runs the train step
with the chosen gradient sync (ring | hier | sparse, the paper's
primitive through the port's CUDA merge kernels), logs loss and
throughput, and checkpoints through ``repro_torch.checkpoint.store``.
``--device`` defaults to the current CUDA device and raises without
one; ``--device cpu`` runs the kernels' plain versions.  ``--dp-degrees
auto`` resolves through the port's calibrated, cached autotuner
(``$REPRO_PLAN_CACHE``).  A VLM's stub image embeddings and an
encoder-decoder's stub frames come with each batch.  ``--sync-overlap
bucketed`` (``hier`` / ``sparse``) syncs the dense leaves in
``--sync-bucket-kb`` buckets issued stage-major, with the bits of
``off``; ``--seq`` of 8,192 and more takes the query-chunked attention.
``--replication`` > 1 with an FSDP config raises ``ValueError``, as in
the reference.  ``--arch moonlight-16b-a3b`` (the port's own
``PORT_ARCHS``) trains a DeepSeek-V3 decoder, its MoE aux weighed by the
configuration's ``aux_alpha``; ``--experts-held 8`` holds one of eight
expert-parallel ranks' experts:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch moonlight-16b-a3b --experts-held 8 --data-axis 2 --batch 2 \\
        --seq 4096 --sync sparse --merge fused --dp-degrees 2
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def batch_stream(cfg, batch: int, seq: int, seed: int = 0):
    """The reference launcher's deterministic batch source: a seeded Zipf
    ``Batcher`` plus one ``RandomState(seed)`` for the multimodal
    tensors.  Equal ``(cfg, batch, seq, seed)`` give byte-identical
    streams, so an exact resume replays and skips."""
    from repro_torch.data.pipeline import Batcher
    batcher = iter(Batcher(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed))
    rng = np.random.RandomState(seed)
    while True:
        toks, labels = next(batcher)
        b = {"tokens": toks, "labels": labels}
        if cfg.img_tokens:
            b["img_embeds"] = rng.randn(
                batch, cfg.img_tokens, cfg.d_model).astype(np.float32)
        if cfg.enc_layers:
            b["enc_frames"] = rng.randn(
                batch, cfg.enc_seq, cfg.d_model).astype(np.float32)
        yield b


def parse_degrees(text: str):
    """``--dp-degrees``: ``auto``, ``rr`` / empty (one round-robin stage)
    or a comma list such as ``4,2``."""
    if text in ("rr", ""):
        return None
    if text == "auto":
        return "auto"
    return {"data": tuple(int(x) for x in text.split(","))}


def main(argv=None):
    """Run the launcher; returns the last step's loss."""
    from repro_torch.checkpoint.store import save as ckpt_save
    from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import DeepSeekV3Config
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step, mesh_ctx

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=list(ARCHS) + list(PORT_ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sync", default="ring",
                    choices=["ring", "hier", "sparse"])
    ap.add_argument("--dp-degrees", default="auto",
                    help="butterfly degrees of the data axis, e.g. '4,2'; "
                         "'auto' resolves through the calibrated, cached "
                         "autotuner; 'rr' keeps one round-robin stage")
    ap.add_argument("--retune", action="store_true",
                    help="bypass the plan cache and re-run the degree sweep")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--merge", default="sort",
                    choices=["sort", "fused", "banded"],
                    help="per-layer merge of the sparse sync: re-sort, or "
                         "the rank-merge + scatter kernels (fused), or "
                         "their band-limited variant")
    ap.add_argument("--wire", default="raw",
                    choices=["raw", "delta", "delta+bf16", "delta+int8ef"],
                    help="payload encoding of the sparse sync ('delta' is "
                         "bit-identical to raw; the last two quantize)")
    ap.add_argument("--sync-overlap", default="off",
                    choices=["off", "bucketed"],
                    help="gradient-sync schedule (hier / sparse sync): "
                         "'bucketed' groups the dense butterfly's leaves "
                         "into byte-bounded buckets issued stage-major; "
                         "results are bit for bit those of 'off'")
    ap.add_argument("--sync-bucket-kb", type=int, default=4096,
                    help="bucket budget (KiB) of --sync-overlap bucketed; "
                         "a leaf above it gets a bucket of its own")
    ap.add_argument("--replication", type=int, default=1,
                    help="r-way replicated data parallelism (paper §V)")
    ap.add_argument("--dead", default="",
                    help="comma-separated dead data positions")
    ap.add_argument("--data-axis", type=int, default=8,
                    help="stacked data-parallel positions M")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="tensor-parallel positions within each data "
                         "position (vocab, heads and experts sharded)")
    ap.add_argument("--untied", action="store_true",
                    help="untie embeddings (sparse sync acts on input emb)")
    ap.add_argument("--experts-held", type=int, default=0,
                    help="a DeepSeek-V3 arch: hold and compute experts "
                         "[0, N) of its router's, one expert-parallel "
                         "rank's share (0: all)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.untied:
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    deepseek = isinstance(cfg, DeepSeekV3Config)
    if args.experts_held:
        if not deepseek:
            raise ValueError("--experts-held: a DeepSeek-V3 arch only")
        cfg = dataclasses.replace(cfg, experts_held=args.experts_held)

    mc = mesh_ctx(args.data_axis, args.model_axis, device=args.device)
    dead = {int(x) for x in args.dead.split(",") if x} or None
    repl = ""
    if args.replication > 1 or dead:
        repl = (f" replication={args.replication}"
                f" dead={sorted(dead) if dead else []}")
    print(f"mesh data={mc.dp} model={mc.tp} on {mc.device}; arch={cfg.name} "
          f"({cfg.param_count() / 1e6:.1f}M params) sync={args.sync}{repl}")
    step, _ = make_train_step(
        cfg, mc, sync=args.sync, opt=AdamW(lr=args.lr),
        microbatch=args.microbatch, dp_degrees=parse_degrees(args.dp_degrees),
        aux_weight=cfg.aux_alpha if deepseek else 0.01,
        sparse_tokens_hint=max(8, args.batch * args.seq // mc.dp),
        sync_merge=args.merge, sync_wire=args.wire,
        replication=args.replication, dead=dead, retune=args.retune,
        sync_overlap=args.sync_overlap,
        sync_bucket_bytes=args.sync_bucket_kb * 1024)
    params = T.init_params(cfg, mc.tp, seed=args.seed, device=mc.device)
    opt_state = AdamW().init(params)
    stream = batch_stream(cfg, args.batch, args.seq, seed=args.seed)

    t_start = time.time()
    r = args.replication
    m = None
    for i in range(args.steps):
        batch = next(stream)
        if r > 1:
            # position i + j * (M / r) sees logical shard i's rows
            batch = {k: np.tile(v, (r,) + (1,) * (v.ndim - 1))
                     for k, v in batch.items()}
        params, opt_state, m = step(params, opt_state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            dt = time.time() - t_start
            tput = (i + 1) * args.batch * args.seq / dt
            print(f"step {i:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['gnorm']):.3f} aux {float(m['aux']):.4f} "
                  f"overflow {int(m['sync_overflow'])} tok/s {tput:.0f}")
    if args.ckpt:
        ckpt_save(args.ckpt, {"params": params},
                  meta={"arch": cfg.name, "steps": args.steps})
        print(f"checkpoint -> {args.ckpt}")
    return float(m["loss"]) if m is not None else float("nan")


if __name__ == "__main__":
    main()
