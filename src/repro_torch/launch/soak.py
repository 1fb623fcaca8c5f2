"""Exact-resume soak harness: train / PageRank under fault schedules (reference: ``repro.launch.soak``).

    PYTHONPATH=src python -m repro_torch.launch.soak --job train --reduced \\
        --steps 6 --ckpt-every 2 --dp 4 --replication 2 --faults rack \\
        --fault-at 3 --num-failures 5 --rack-size 5 --out /tmp/soak
    PYTHONPATH=src python -m repro_torch.launch.soak --job pagerank \\
        --vertices 262144 --edges 2000000 --graph-nodes 64 --pool 80 \\
        --steps 10 --ckpt-every 2 --faults rack --fault-at 3 \\
        --num-failures 5 --rack-size 5 --out /tmp/soak [--device cpu]

Runs a job to completion while a :mod:`repro_torch.core.faults`
schedule kills pool positions mid-run, checkpointing every
``--ckpt-every`` steps (rounds) through the atomic
:mod:`repro_torch.checkpoint.store`.  ``--kill-at N`` hard-exits the
process (code 17) after step N; rerun with ``--resume`` to continue from
the newest valid checkpoint (corrupt ones are skipped) and finish with
``final.npz`` equal, array for array, to an uninterrupted fault-free run.

The train job is the reference's: ``--dp`` logical shards over ``dp *
replication`` roles, each role bound to a pool position; the batch
stream is replayed and skipped on resume
(``repro_torch.launch.train.batch_stream``) and the checkpoint's
``train_fingerprint`` must match.  A dead position that only hits a
redundant replica is absorbed (contribution weights); a lost replica
group remaps its roles onto alive positions (the same program, the same
bits); without enough positions the job drops replication, or exits 3
below quorum.  The PageRank job drives
:class:`repro_torch.resilience.SupervisedEngineLoop`: a dead position
that hosts a partition triggers a remap onto a spare (bit-identical).
``--pool N`` is the fleet size (the reference's device count);
``--device`` binds the run (default: the current CUDA device; ``cpu``
runs the kernels' plain versions).  Both jobs print ``SOAK_LAUNCHES``
(the kernel wrappers' launch counts; a CUDA graph's kernels count once,
when its capture enqueues them, not per replay) and ``SOAK_OK``; the
PageRank job also
``SOAK_ENGINE`` (its last engine's runs, rounds, graph launches and
captures).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.checkpoint import store
from repro_torch.core.faults import SCHEDULE_KINDS, make_schedule

KILL_EXIT = 17      #: exit code of a --kill-at hard stop (not a failure)
QUORUM_EXIT = 3     #: exit code when too few positions survive


def parse_args(argv=None):
    """The soak CLI (the reference's flags, plus ``--pool`` and
    ``--device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", default="pagerank",
                    choices=["train", "pagerank"])
    ap.add_argument("--steps", type=int, default=6,
                    help="total train steps / PageRank rounds")
    ap.add_argument("--ckpt-every", type=int, default=2,
                    help="checkpoint (and block) interval; keep it fixed "
                         "between a baseline and a resumed run to compare "
                         "them bit for bit")
    ap.add_argument("--faults", default="none",
                    choices=("none",) + SCHEDULE_KINDS,
                    help="failure schedule kind over the pool "
                         "(repro_torch.core.faults)")
    ap.add_argument("--fault-at", type=int, default=0,
                    help="first step / round at which the schedule applies")
    ap.add_argument("--num-failures", type=int, default=1)
    ap.add_argument("--rack-size", type=int, default=4)
    ap.add_argument("--kill-at", type=int, default=0,
                    help="hard-exit (code 17) once this step completes "
                         "and checkpoints; ignored under --resume")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest valid checkpoint in "
                         "--out (corrupt ones are skipped)")
    ap.add_argument("--out", required=True,
                    help="checkpoint + final-state directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--pool", type=int, default=None,
                    help="node positions in the fleet (default: "
                         "max(16, --graph-nodes) for PageRank, max(16, "
                         "--dp * --replication) for train)")
    # train job
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sync", default="ring",
                    choices=["ring", "hier", "sparse"])
    ap.add_argument("--merge", default="sort",
                    choices=["sort", "fused", "banded"])
    ap.add_argument("--dp", type=int, default=4,
                    help="logical data-parallel shards (train job)")
    ap.add_argument("--replication", type=int, default=1,
                    help="r-way replica groups over dp * r roles")
    # pagerank job
    ap.add_argument("--vertices", type=int, default=400)
    ap.add_argument("--edges", type=int, default=2000)
    ap.add_argument("--graph-nodes", type=int, default=4,
                    help="graph partitions M")
    return ap.parse_args(argv)


def _latest_valid(out_dir: str):
    """Newest loadable checkpoint ``(round, arrays, meta)`` or ``None``,
    skipping corrupt artifacts."""
    for step, base in store.list_checkpoints(out_dir):
        try:
            arrays, meta = store.load_flat(base)
            return step, arrays, meta
        except store.CheckpointError as e:
            print(f"skipping corrupt checkpoint {base}: {e}",
                  file=sys.stderr)
    return None


def run_train(args) -> int:
    """Training under the schedule: returns the exit code (0, 17 on
    --kill-at, 3 on quorum loss)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.transport import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW, AdamWState
    from repro_torch.resilience.events import (GROUP_LOST, QUORUM_LOST,
                                               REPLICA_ABSORBED, classify)
    from repro_torch.train.step import (make_train_step, mesh_ctx,
                                        train_fingerprint)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    dp, r = args.dp, args.replication
    m_roles = dp * r
    pool = args.pool if args.pool is not None else max(16, m_roles)
    if pool < m_roles:
        raise ValueError(f"{pool} positions < {m_roles} roles")
    schedule = None
    if args.faults != "none":
        schedule = make_schedule(args.faults, pool, args.num_failures,
                                 seed=args.seed, rack_size=args.rack_size)
    fp = train_fingerprint(cfg, batch=args.batch, seq=args.seq, lr=args.lr,
                           sync=args.sync, merge=args.merge, dp=dp,
                           replication=r, seed=args.seed,
                           mesh=mesh_ctx(m_roles, device=device).shape)

    # role -> pool position; sticky until a fault forces a remap
    assignment = list(range(m_roles))
    r_eff = r
    step_cache = {}

    def get_step(assign, dead_roles, r_now):
        key = (tuple(assign), frozenset(dead_roles), r_now)
        if key not in step_cache:
            fn, _ = make_train_step(
                cfg, mesh_ctx(len(assign), device=device), sync=args.sync,
                opt=AdamW(lr=args.lr), dp_degrees=None,
                sync_merge=args.merge,
                sparse_tokens_hint=max(8, args.batch * args.seq
                                       // len(assign)),
                replication=r_now, dead=set(dead_roles) or None)
            step_cache[key] = fn
        return step_cache[key]

    _build.reset_launches()
    params = T.init_params(cfg, 1, seed=args.seed, device=device)
    opt = AdamW(lr=args.lr)
    opt_state = opt.init(params)
    start, losses, events = 0, [], []
    if args.resume:
        hit = _latest_valid(args.out)
        if hit is not None:
            start, arrays, meta = hit
            if meta["fingerprint"] != fp:
                raise SystemExit(
                    f"checkpoint fingerprint {meta['fingerprint']} does not "
                    f"match this invocation ({fp}): resuming would diverge")
            like = {"params": params, "opt_m": opt_state.m,
                    "opt_v": opt_state.v}
            tree = store.load(f"{args.out}/ckpt-{start}", like)
            params = tree["params"]
            opt_state = AdamWState(
                step=torch.as_tensor(arrays["opt_step"], device=device),
                m=tree["opt_m"], v=tree["opt_v"])
            losses = [float(x) for x in meta["losses"]]
            events = list(meta.get("events", []))
            print(f"resumed at step {start} from {args.out}/ckpt-{start}")

    stream = batch_stream(cfg, args.batch, args.seq, seed=args.seed)
    for _ in range(start):
        next(stream)       # exact resume: replay and skip the batch source

    def state_tree():
        return {"params": params, "opt_m": opt_state.m, "opt_v": opt_state.v,
                "opt_step": opt_state.step}

    dead_roles = frozenset()
    for i in range(start, args.steps):
        dead_pool = set(schedule.dead_at(i)) \
            if schedule is not None and i >= args.fault_at else set()
        new_dead = frozenset(role for role, p in enumerate(assignment)
                             if p in dead_pool)
        ev = classify(len(assignment), r_eff, set(new_dead))
        if ev.klass == GROUP_LOST or \
                (ev.klass == QUORUM_LOST and r_eff > 1):
            alive = [p for p in range(pool) if p not in dead_pool]
            if len(alive) >= len(assignment):
                # remap: the same program on alive positions, same bits
                assignment = alive[: len(assignment)]
                new_dead = frozenset()
                events.append(f"remap@{i}")
            elif len(alive) >= dp:
                # degrade: drop replication, keep every logical shard
                assignment, r_eff = alive[:dp], 1
                new_dead = frozenset()
                events.append(f"drop-replication@{i}")
            else:
                print(f"QUORUM_LOST step {i}: {len(alive)} alive < dp={dp}")
                return QUORUM_EXIT
        elif ev.klass == QUORUM_LOST:
            print(f"QUORUM_LOST step {i}: dead roles {sorted(new_dead)}")
            return QUORUM_EXIT
        elif ev.klass == REPLICA_ABSORBED and new_dead != dead_roles:
            events.append(f"absorbed@{i}")
        dead_roles = new_dead

        step_fn = get_step(assignment, dead_roles, r_eff)
        batch = next(stream)
        if r_eff > 1:
            batch = {k: np.tile(v, (r_eff,) + (1,) * (v.ndim - 1))
                     for k, v in batch.items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        done = i + 1
        if args.ckpt_every and done % args.ckpt_every == 0:
            store.save(f"{args.out}/ckpt-{done}", state_tree(),
                       meta={"step": done, "losses": losses,
                             "fingerprint": fp, "events": events})
        if args.kill_at and done == args.kill_at and not args.resume:
            print(f"KILL step {done} (simulated crash)")
            sys.stdout.flush()
            return KILL_EXIT

    store.save(f"{args.out}/final", state_tree(),
               meta={"steps": args.steps, "losses": losses,
                     "fingerprint": fp, "events": events})
    print("SOAK_LAUNCHES " + json.dumps(dict(_build.LAUNCHES)))
    print(f"SOAK_OK job=train steps={args.steps} "
          f"loss={losses[-1]:.6f} events={events}")
    return 0


def run_pagerank(args) -> int:
    """PageRank under the schedule through ``SupervisedEngineLoop``;
    returns the exit code (0, 17 on --kill-at, 3 on quorum loss)."""
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.pagerank import (assemble_pagerank_scores,
                                            build_partitions,
                                            make_pagerank_app,
                                            pagerank_state)
    from repro_torch.kernels import _build
    from repro_torch.resilience import QuorumLost, SupervisedEngineLoop

    m = args.graph_nodes
    pool = args.pool if args.pool is not None else max(16, m)
    damping = 0.85
    edges = powerlaw_graph(args.vertices, args.edges, seed=args.seed)
    parts = build_partitions(edges, args.vertices, m, seed=args.seed)
    app, out_sets, in_sets = make_pagerank_app(parts, args.vertices, damping)
    schedule = None
    if args.faults != "none":
        schedule = make_schedule(args.faults, pool, args.num_failures,
                                 seed=args.seed, rack_size=args.rack_size)

    killed = {"flag": False}

    def on_block(rnd, state):
        if args.kill_at and rnd >= args.kill_at and not args.resume \
                and not killed["flag"]:
            killed["flag"] = True
            print(f"KILL round {rnd} (simulated crash)")
            sys.stdout.flush()
            sys.exit(KILL_EXIT)

    _build.reset_launches()
    loop = SupervisedEngineLoop(
        out_sets, in_sets, app, degrees=(m,), seed=args.seed,
        schedule=schedule, fault_at=args.fault_at, ckpt_dir=args.out,
        ckpt_every=args.ckpt_every, pool=pool, device=args.device,
        on_block=on_block)
    extras, p0 = pagerank_state(parts, args.vertices, loop.engine.u_cap,
                                loop.engine.uin_cap,
                                device=loop.engine.device)
    start, state = 0, p0
    if args.resume:
        hit = _latest_valid(args.out)
        if hit is not None:
            start, arrays, _ = hit
            state = arrays["state"]
            print(f"resumed at round {start} from {args.out}/ckpt-{start}")
    try:
        state, last_q = loop.run(args.steps, state, extras,
                                 start_round=start)
    except QuorumLost as e:
        print(f"QUORUM_LOST {e}")
        return QUORUM_EXIT
    scores = assemble_pagerank_scores(parts, last_q, args.vertices, damping)
    events = [e.klass for e in loop.events]
    store.save(f"{args.out}/final",
               {"state": store.to_numpy(state),
                "last_q": store.to_numpy(last_q), "scores": scores},
               meta={"rounds": args.steps, "remaps": loop.remaps,
                     "events": events})
    print("SOAK_LAUNCHES " + json.dumps(dict(_build.LAUNCHES)))
    report = loop.engine.sync_report()
    print("SOAK_ENGINE " + json.dumps(
        {k: report[k] for k in ("dispatches", "rounds", "graph_launches",
                                "captures")}))
    print(f"SOAK_OK job=pagerank rounds={args.steps} remaps={loop.remaps} "
          f"events={events}")
    return 0


def main(argv=None) -> int:
    """Entry point; returns the process exit code (0 ok, 17 simulated
    crash, 3 quorum lost)."""
    args = parse_args(argv)
    return run_train(args) if args.job == "train" else run_pagerank(args)


if __name__ == "__main__":
    sys.exit(main())
