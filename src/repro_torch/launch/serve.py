"""Serving launcher: continuous-batching decode with admission control (reference: ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 16 --prompt-len 512 --gen 32 --slots 8 --data-axis 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --device cpu --requests 4 --prompt-len 8 --gen 4 \\
        --sparse-dispatch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --reduced --device cpu

Thin CLI over ``repro_torch.serve``: a Zipf request stream
(``repro_torch.serve.service.zipf_request_stream``) runs through the
:class:`~repro_torch.serve.queue.AdmissionController` (``--rate`` /
``--burst`` / ``--queue-cap`` / ``--slo-steps``; rate 0 disables
admission) into the :class:`~repro_torch.serve.scheduler.
ContinuousBatchingScheduler` (``--slots``), with the sparse exchange
enabled by ``--sparse-dispatch`` (``--wire`` / ``--head-size``; see
``repro_torch.serve.dispatch``).  Token sampling is greedy on the
device: only int32 ids come back to the host.

The mesh stacks ``--data-axis`` data positions (the reference's data
axis, default 1: one device), each with ``--model-axis`` model
positions, on one device (``repro_torch.train.step.mesh_ctx``).
``--device`` defaults to the current CUDA device and raises without
one; ``--device cpu`` runs the kernels' plain versions.

Encoder / vision archs (whisper, internvl) have no per-request
cross-state isolation in the slot cache, so they serve through the
fixed-batch loop below -- also on the fused greedy steps (whisper's
cross cache built once for the batch, internvl's decode positions
starting after its image tokens).
"""
from __future__ import annotations

import argparse

import numpy as np


def _cross_cache(cfg, mc, params, frames):
    """The encoder-decoder's cross cache of a batch's frames [B, S, d],
    its rows split over the mesh's data positions."""
    from repro_torch.models import transformer as T
    from repro_torch.train import step as S
    return T.build_cross_cache(S.serving_tree(params, cfg, mc),
                               S._stack_tokens(frames, mc, dtype=None), cfg,
                               mc.axis_ctx(cfg))


def _fixed_batch_generate(cfg, mc, params, args) -> np.ndarray:
    """Fixed-batch prefill + decode for encoder / vision archs:
    ``--requests`` rows (a multiple of ``--data-axis``), ``--gen`` ids
    each."""
    from repro_torch.train.step import (make_decode_greedy_step,
                                        make_prefill_greedy_step)
    max_seq = args.prompt_len + args.gen + (cfg.img_tokens or 0)
    prefill, _ = make_prefill_greedy_step(cfg, mc, max_seq=max_seq)
    decode, _ = make_decode_greedy_step(cfg, mc)

    rng = np.random.RandomState(args.seed)
    b = args.requests
    batch = {"tokens": rng.randint(0, cfg.vocab,
                                   (b, args.prompt_len)).astype(np.int32)}
    if cfg.img_tokens:
        batch["img_embeds"] = rng.randn(
            b, cfg.img_tokens, cfg.d_model).astype(np.float32)
    if cfg.enc_layers:
        batch["enc_frames"] = rng.randn(
            b, cfg.enc_seq, cfg.d_model).astype(np.float32)

    tok, cache = prefill(params, batch)
    extra = ()
    if cfg.enc_layers:
        extra = (_cross_cache(cfg, mc, params, batch["enc_frames"]),)

    pos0 = args.prompt_len + (cfg.img_tokens or 0)
    outputs = [tok.cpu().numpy()]
    for i in range(args.gen - 1):
        pos = np.full((b,), pos0 + i, np.int32)
        tok, cache = decode(params, tok, pos, cache, *extra)
        outputs.append(tok.cpu().numpy())
    return np.stack(outputs, axis=1)


def main(argv=None):
    from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.step import mesh_ctx

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=list(ARCHS) + list(PORT_ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--data-axis", type=int, default=1,
                    help="stacked data-parallel positions M")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous-batching slot count (0: auto -- up to "
                         "8, rounded to the data-axis size)")
    ap.add_argument("--alpha", type=float, default=1.2,
                    help="Zipf exponent of the request-stream prompts")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="token-bucket admit rate in requests/step "
                         "(0: admission control off)")
    ap.add_argument("--burst", type=float, default=4.0,
                    help="token-bucket burst capacity")
    ap.add_argument("--queue-cap", type=int, default=16,
                    help="bounded-queue capacity (beyond it: load shed)")
    ap.add_argument("--slo-steps", type=float, default=64.0,
                    help="latency SLO in decode steps (circuit breaker)")
    ap.add_argument("--breach-window", type=int, default=8,
                    help="consecutive SLO breaches before the breaker trips")
    ap.add_argument("--cooldown-steps", type=float, default=32.0,
                    help="breaker open->half-open cooldown in steps")
    ap.add_argument("--sparse-dispatch", action="store_true",
                    help="route token/expert statistics through "
                         "SparseAllreduce (repro_torch.serve.dispatch)")
    ap.add_argument("--wire", default="raw",
                    help="wire codec for the dispatch tail union "
                         "(raw | delta | delta+bf16 | delta+int8ef)")
    ap.add_argument("--head-size", type=int, default=64,
                    help="Zipf hot-set size for the frozen dispatch plan")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    T.check_servable(cfg)
    mc = mesh_ctx(args.data_axis, args.model_axis, device=args.device)
    params = T.init_params(cfg, mc.tp, seed=args.seed, device=mc.device)

    if cfg.enc_layers or cfg.img_tokens:
        gen = _fixed_batch_generate(cfg, mc, params, args)
        print(f"fixed-batch {args.arch}: {gen.shape[0]} requests x "
              f"{gen.shape[1]} tokens")
        print("generated ids[0]:", gen[0][:12])
        return gen

    from repro_torch.serve import (AdmissionController,
                                   ContinuousBatchingScheduler,
                                   DecodeService, zipf_request_stream)
    slots = args.slots or max(mc.dp, min(args.requests, 8)
                              // mc.dp * mc.dp or mc.dp)
    max_seq = args.prompt_len + args.gen + 1
    dispatch = None
    if args.sparse_dispatch:
        from repro_torch.serve.dispatch import SparseServeDispatch
        dispatch = SparseServeDispatch(
            mc.dp, vocab=cfg.vocab, n_experts=cfg.n_experts,
            wire=args.wire, seed=args.seed + 1, device=mc.device)
    sched = ContinuousBatchingScheduler(
        cfg, mc, params, slots=slots, max_seq=max_seq, dispatch=dispatch)
    admission = None
    if args.rate > 0:
        admission = AdmissionController(
            rate=args.rate, burst=args.burst, queue_cap=args.queue_cap,
            slo=args.slo_steps, breach_window=args.breach_window,
            cooldown=args.cooldown_steps)
    reqs = zipf_request_stream(
        args.requests, cfg.vocab, alpha=args.alpha,
        prompt_lens=(args.prompt_len,), max_new=(args.gen, args.gen),
        seed=args.seed)
    if dispatch is not None:
        warm = np.concatenate([np.asarray(r.prompt).reshape(-1)
                               for r in reqs])
        dispatch.fit_hot_set(warm, head_size=args.head_size)
    report = DecodeService(sched, admission).run(reqs)
    done = sorted(report.completed, key=lambda r: r.rid)
    gen = np.asarray([r.tokens for r in done], np.int32) if done \
        else np.zeros((0, args.gen), np.int32)
    print(f"served {len(done)}/{args.requests} requests in {report.steps} "
          f"steps ({report.tokens_per_s:.1f} tok/s wall); "
          f"p50={report.p50_steps:.0f} p99={report.p99_steps:.0f} steps")
    if admission is not None:
        s = admission.stats
        print(f"admission: offered={s.offered} admitted={s.admitted} "
              f"shed(rate/queue/breaker)="
              f"{s.shed_rate}/{s.shed_queue}/{s.shed_breaker}")
    if dispatch is not None:
        print(f"dispatch: plan hit rate {dispatch.plan_hit_rate:.2f} over "
              f"{dispatch.plan_resolutions} resolutions")
    if len(gen):
        print("generated ids[0]:", gen[0][:12])
    return gen


if __name__ == "__main__":
    main()
