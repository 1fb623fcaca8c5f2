"""Exact-resume soak harness: PageRank under fault schedules (reference: ``repro.launch.soak``).

    PYTHONPATH=src python -m repro_torch.launch.soak --job pagerank \\
        --vertices 262144 --edges 2000000 --graph-nodes 64 --pool 80 \\
        --steps 10 --ckpt-every 2 --faults rack --fault-at 3 \\
        --num-failures 5 --rack-size 5 --out /tmp/soak [--device cpu]

Runs PageRank to completion through
:class:`repro_torch.resilience.SupervisedEngineLoop` while a
:mod:`repro_torch.core.faults` schedule kills pool positions mid-run,
checkpointing every ``--ckpt-every`` rounds through the atomic
:mod:`repro_torch.checkpoint.store`.  ``--kill-at N`` hard-exits the
process (code 17) after round N; rerun with ``--resume`` to continue
from the newest valid checkpoint (corrupt ones are skipped) and finish
with ``final.npz`` equal, array for array, to an uninterrupted
fault-free run.  A dead position that hosts a partition triggers a remap
onto a spare (bit-identical); with too few positions left the job exits
3.  ``--pool N`` is the fleet size (the reference's device count);
``--device`` binds the run (default: the current CUDA device; ``cpu``
runs the kernels' plain versions).  ``--job train`` waits for the
training stack (ROADMAP Queue 1 item 11) and raises.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.checkpoint import store
from repro_torch.core.faults import SCHEDULE_KINDS, make_schedule

KILL_EXIT = 17      #: exit code of a --kill-at hard stop (not a failure)
QUORUM_EXIT = 3     #: exit code when too few positions survive


def parse_args(argv=None):
    """The soak CLI (the reference's PageRank flags; the train job's come
    with the training stack)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", default="pagerank",
                    choices=["train", "pagerank"])
    ap.add_argument("--steps", type=int, default=6,
                    help="total PageRank rounds")
    ap.add_argument("--ckpt-every", type=int, default=2,
                    help="checkpoint (and block) interval; keep it fixed "
                         "between a baseline and a resumed run to compare "
                         "them bit for bit")
    ap.add_argument("--faults", default="none",
                    choices=("none",) + SCHEDULE_KINDS,
                    help="failure schedule kind over the pool "
                         "(repro_torch.core.faults)")
    ap.add_argument("--fault-at", type=int, default=0,
                    help="first round at which the schedule applies")
    ap.add_argument("--num-failures", type=int, default=1)
    ap.add_argument("--rack-size", type=int, default=4)
    ap.add_argument("--kill-at", type=int, default=0,
                    help="hard-exit (code 17) once this round completes "
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
                         "max(16, --graph-nodes))")
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
    """The soak's training job: not ported yet."""
    raise NotImplementedError(
        "soak --job train needs the training stack, not ported yet "
        "(ROADMAP Queue 1 item 11)")


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
