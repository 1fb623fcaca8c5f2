#!/usr/bin/env python3
"""The planned reduce's down-half sums before and after their fixed order, on one NVIDIA GPU.

    python3 tools/planned_sum_ab.py

Builds the smoke's PageRank plan (a 2^18-vertex, 2 M-edge power-law graph
over 64 nodes, degrees (16, 4)) and, in turns on the same card and
inputs, times:

* ``before`` -- the down half as it summed up to the parent commit:
  float ``index_add_`` scatters (atomics on CUDA), defined here;
* ``after`` -- the port's ``PlannedSparseAllreduce`` as it is, whose sums
  run in a fixed order (``planned._FixedOrderSum``);

as one planned reduce (CUDA events) and as one PageRank engine round
(host wall time over 10 rounds after a warm-up run).  It also reduces the
same normal float32 values 10 times with each and counts the outputs
whose bits differ from the first call.  Prints the card's name and power
limit, then one JSON line.  Needs a CUDA GPU.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def index_add_down(planned, values, routing):
    """The down half with float ``index_add_`` scatters, as it summed
    before its sums took a fixed order (atomics on CUDA; source order on
    the CPU).  ``tests/test_torch_allreduce.py`` holds the fixed-order
    sums to it."""
    import torch
    from repro_torch.core.planned import _gather
    m, wshape = values.shape[0], values.shape[2:]
    cache = routing_offsets(planned, routing)

    def scatter_add(flat_index, src, size):
        out = torch.zeros((m * (size + 1),) + wshape, dtype=values.dtype,
                          device=values.device)
        out.index_add_(0, flat_index, src.reshape((-1,) + wshape))
        return out.reshape((m, size + 1) + wshape)[:, :size]

    cur = scatter_add(cache["user"], values, planned.sorted_size)
    for l, L in enumerate(planned.layers):
        send_g, send_m = routing.layers[l][:2]
        k, cap = L.send_gather.shape[1], L.send_gather.shape[2]
        picked = _gather(cur, send_g, send_m).reshape((m, k, cap) + wshape)
        (recv,) = routing.transport.all_to_all(l, picked)
        cur = scatter_add(cache[l], recv, L.merged_size)
    return _gather(cur, routing.bottom_gather, routing.bottom_hit)


_OFFSETS = {}


def routing_offsets(planned, routing):
    """``node * (size + 1) + slot`` scatter offsets on the routing's
    device, built once per plan and device (the entry keeps its plan
    alive, so its id is never reused)."""
    from repro_torch.core.planned import _flat_offsets
    dev = routing.transport.device
    key = (id(planned), str(dev))
    if key not in _OFFSETS:
        out = {"user": _flat_offsets(planned.user_scatter,
                                     planned.sorted_size, dev)}
        for l, L in enumerate(planned.layers):
            out[l] = _flat_offsets(L.merge_scatter, L.merged_size, dev)
        _OFFSETS[key] = (planned, out)
    return _OFFSETS[key][1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("planned_sum_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.planned import PlannedSparseAllreduce
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.pagerank import (build_partitions,
                                            make_pagerank_engine)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    edges = powerlaw_graph(262_144, 2_000_000, alpha=2.0, seed=0)
    parts = build_partitions(edges, 262_144, 64)
    engine, extras, p0 = make_pagerank_engine(parts, 262_144, (16, 4),
                                              device="cuda")
    planned, routing = engine.planned, engine._routing
    after = PlannedSparseAllreduce.reduce_down_on_device

    def before(self, values, routing=None):
        return index_add_down(self, values,
                              routing or self.device_args(values.device))

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((64, planned.u_cap), generator=gen, device="cuda")
    result = {"u_cap": planned.u_cap,
              "fans": [routing.user_scatter.fan]
              + [lay[2].fan for lay in routing.layers]}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for turn in ("before", "after", "after", "before"):
        PlannedSparseAllreduce.reduce_down_on_device = \
            before if turn == "before" else after
        fn = lambda: planned.reduce_on_device(x, routing)
        first = fn()
        differ = sum(int((fn() != first).sum()) for _ in range(9))
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        reduce_ms = start.elapsed_time(end) / 20
        engine.run(10, p0, extras)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(10, p0, extras)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) / 10 * 1e3
        result.setdefault(turn, []).append(
            {"reduce_ms": reduce_ms, "round_ms": round_ms,
             "differing_outputs_in_9_repeats": differ,
             "outputs": int(first.numel())})
    PlannedSparseAllreduce.reduce_down_on_device = after
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
