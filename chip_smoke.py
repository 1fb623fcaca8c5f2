#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its main path through the user entry points, then holds every
kernel against its plain PyTorch version on the main path's own inputs.
Every phase asserts, and any failure exits non-zero.  Phases (one JSON
line each, after the ``nvidia-smi`` name/power-limit line):

1. build   -- the kernels' library (``nvcc`` for sm_90a, in parallel);
2. planned -- ``SparseAllreduce(64, (16, 4), backend="device")`` config +
   reduce on the PageRank partitions' index sets, against the float64
   ``backend="sim"`` oracle;
3. union   -- ``union_reduce`` on 64 nodes x 16,384 coalesced Zipf(1.4)
   hashed indices with dyadic values: ``merge="fused"`` equals
   ``merge="sort"`` bit for bit, and both equal a numpy dense oracle;
4. pagerank -- ``pagerank(backend="device")`` on a 2^18-vertex, 2 M-edge
   power-law graph over M=64 nodes, degrees (16, 4), 10 rounds, through
   the stacked-CSR SpMV kernel, against the float64 dense reference; the
   CSR's nonzeros and bytes, peak device memory during the entry point
   (``max_memory_allocated``: all that is allocated, the earlier phases'
   leftovers included, as PR 12's smoke reported it; and its rise over
   what was allocated before the call), then per-round wall time;
5. hadi -- ``hadi(backend="device")`` on the same graph, 16 hops of 4 x
   24-bit FM strings (W = 96 values an index) through the width-W product
   on the stacked CSR: bitstrings, curve, effective diameter and hops run
   equal to a float64 global OR iteration of the same start strings (a
   scipy CSR product of the whole graph, clamped), one engine run; ms per
   hop, state and trajectory bytes, peak memory, the product's ms;
6. spectral -- ``power_iteration(backend="device")``, 30 rounds on the
   symmetrized graph (3.96 M nonzeros) through the CSR SpMV kernel and
   the whole-mesh sum: eigenvalue within 1e-4 relative and eigenvector
   cosine above 1 - 1e-6 of the float64 ``power_iteration_reference``,
   30 kernel launches; ms per round;
7. pagerank_large -- the same at 2^20 vertices and 10 M edges, a graph
   whose padded ELL tables would need some 288 GB: rtol 1e-4 against the
   float64 dense reference, round wall time, peak memory, host set-up;
8. union_wire -- ``union_reduce`` at mini-batch scale: 64 nodes x
   262,144 Zipf(1.1) draws over 2^24 hashed features each (about 103,000
   unique per node, a ~3.96 M-entry union), for all 12 (merge, wire)
   pairs: indices exact everywhere, raw/delta values exact against the
   float64 oracle, delta+bf16 bit-identical across merges, delta+int8ef
   merges within 1e-5 x max|union| of each other and 0.05 x max|union|
   of the exact sum; CUDA-event ms and launches per reduce of each pair,
   and for the fused and banded merges under the raw wire the device ms
   of one reduce and its twelve largest kernels (profiler);
9. replicated_planned -- ``SparseAllreduce(64, (16, 4), replication=2,
   dead=D)`` (128 physical nodes) config + reduce on PageRank's index sets
   with dyadic values: bit for bit equal to the unreplicated reduce and to
   the sim backend with the same replication and dead set;
   ``reconfig_dead(D2)`` the same bits with ``config_cache == "repair"``; a
   dead set that covers a replica group raises ``DeadLogicalNode`` and
   leaves the instance usable (D, D2: the first two steps of
   ``make_schedule("random", 128, 8, seed=0)`` that lose no group);
10. replicated_union -- ``union_reduce`` of 32 logical nodes, degrees (8,
   4), r = 2 (64 physical nodes, a degree-2 replica-merge stage first) on
   the first 32 nodes of union_wire's input, with a dead set from
   ``make_schedule("random", 64, 8, seed=0)``: merges sort, fused and
   banded under the raw wire equal the unreplicated 32-node reduce of the
   same merge bit for bit and the float64 oracle; banded under
   delta+int8ef indices exact and within 0.05 x max|union| of it; ms of
   each replicated and unreplicated reduce, peak memory;
11. plan_cache -- ``SparseAllreduce.config`` on PageRank's index sets
   served fresh, from the memo, from disk (memo cleared) and from disk in
   a restarted process (this script with ``--plan-cache-probe``): the same
   reduce bits on normal floats from all four, the seconds of each tier;
   ``degrees="auto"`` tuned, then cached;
12. calibrate -- ``calibrate_fabric`` over 64 stacked nodes (stage
   degrees 2-64, 256 / 4,096 / 32,768 entries): alpha, beta, gamma and the
   fit residual; ``select_plan`` with ``measure_plan`` trials (fused) of
   the top five, modeled and measured ms; ``resolve_degrees`` under the
   fit for PageRank's nnz (the trials are timing, not main-path calls);
13. resilient_planned -- ``ResilientAllreduce(64, (16, 4),
   replication=2)`` on PageRank's index sets, dyadic values: a
   replica-absorbed dead set repaired in place (bits unchanged), a lost
   group shrunk to 63 survivors (explicit degrees: ``tune``'s), equal to
   a fresh reduce over them, the shrink reused, a loss below quorum
   raising ``QuorumLost``; then with ``degrees="auto"`` the same loss
   shrunk with the degrees ``resolve_degrees(shrunk_from=64)`` gives
   through the base's plan cache (which then serves them), equal to the
   same fresh reduce; ms of each;
14. resilient_union -- replicated_union's input (32 logical x 2) with
   both replicas of one shard dead: 31 survivors at r = 2 over one flat
   layer of 31 runs (an odd merge tree), fused and banded, bit for bit
   equal to a fresh reduce over the survivors and the float64 oracle; ms
   and peak memory;
15. supervised_pagerank -- ``SupervisedEngineLoop`` (M = 64 over a pool of
   80, 10 rounds, checkpoints every 2) under ``make_schedule("rack", 80,
   5, rack_size=5)`` from round 3 (the first seed whose rack hits an
   engine position): final state and last_q equal the fault-free run bit
   for bit, with the remaps' seconds and config tiers;
16. soak_resume -- ``python -m repro_torch.launch.soak --job pagerank`` at
   the same graph size in subprocesses: baseline, a rack-fault run killed
   at round 4 (exit 17), its ``--resume``; final.npz equal array by array,
   and the baseline's equal to one eager loop of the same job in this
   process;
17. train -- the training stack at full width: ``make_train_step`` on
   qwen1.5-0.5b untied (24 layers, d 1,024, vocab 151,936, bf16) over M =
   8 data positions stacked on the card, degrees (4, 2), batch 8 x seq
   256 (sparse capacities in 256, out 2,048), three steps from the same
   weights and batches under ``hier`` and ``sparse`` with sort / fused /
   banded (raw), fused with ``delta`` and ``delta+int8ef``, banded with
   ``delta+int8ef``, then fused / raw again: step, forward + backward,
   sync and update ms (CUDA events; the median of steps 2-3), tokens/s,
   peak memory, losses and overflow; losses finite, the first within 1.5
   of ln(vocab), overflow 0, ``delta`` = ``raw`` and the repeat bit for
   bit, the step-1 float32 embedding sync equal across the merges and to
   ``hier``'s within rtol 1e-5 (+ 1e-7 x max), every other synced leaf
   bit-identical across the sparse configurations; each configuration
   draws its weights afresh and donates them to the step; then
   ``train_tp`` (the model axis: qwen at 4 x 2 and its pair against 4 x
   1, granite-moe at 2 x 2, reduced granite replayed on the CPU) and:
   train_pod -- the ``pod`` axis: qwen at (pod, data, model) = (2, 2, 1)
   with degrees {pod: (2,), data: (2,)} against (4, 1) with {data: (2,
   2)} for ``hier``, sparse fused raw and sparse banded ``delta+int8ef``,
   and (2, 2, 2) against (4, 2) for ``hier`` and sparse fused, two steps
   each from the same weights: losses, step-1 synced gradients and final
   parameters bit for bit;
   train_long -- qwen on M = 2 positions of one 8,192-token row each (the
   query-chunked attention), ``hier`` and sparse fused, two steps: step
   ms, tokens/s, peak memory; the layer-0 attention blocked against
   unblocked at T = 2,048 and 8,192 within 2^-7 x max;
   train_overlap -- qwen as ``train``, ``hier`` with the bucketed schedule
   against ``off``, three steps, bit for bit, with each sync's ms;
18. soak_train -- ``python -m repro_torch.launch.soak --job train
   --reduced --dp 4 --replication 2`` in subprocesses: baseline, a rack
   fault from step 3 killed at step 4 (exit 17), its ``--resume``;
   final.npz and losses equal;
19. train_moe -- granite-moe-3b-a800m untied at full width (32 layers, d
   1,536, 40 experts top-8 of d_ff 512, vocab 49,155 padded to 49,168,
   bf16, 3.37 B parameters) over M = 2 positions of 1,024 tokens, degrees
   (2,): ``hier``, sparse sort / fused / banded (raw), fused and banded
   ``delta+int8ef``, then fused / raw again, the train phase's asserts;
   first the MoE's own numbers at layer 0 on step 1's batch (embed, block
   0's attention, rmsnorm, ``moe_ffn``): dropped fraction, aux loss, the
   copies each expert is sent (max, mean, min), those beyond cap_e, the
   block's forward ms and the ms of the copy ``torch.matmul`` makes of
   the broadcast expert weights;
20. train_ssm -- xlstm-1.3b untied at full width (SSM_LAYERS of its 48
   layers, 7 mLSTM + 1 sLSTM a period, d 2,048, vocab 50,304, bf16) over M = 8, degrees (4,
   2), two steps a configuration: ``hier``, sparse fused / banded (raw),
   fused and banded ``delta+int8ef``, the repeat, the train phase's
   asserts, and the forward ms of one mLSTM and one sLSTM block; reduced
   jamba (7 mamba + 1 attention, dense and MoE FFNs alternating, float32)
   over M = 4, degrees (2, 2), three ``hier`` steps on the card, then
   held to the CPU in this process, each step from the card's state
   before it: loss and aux within rtol 1e-4 (step 1 a whole CPU step,
   steps 2 and 3 a CPU forward), step 1's synced gradients within rtol
   1e-4 + 1e-3 x max of the CPU step's, each step's gradient norm within
   rtol 1e-5 of its synced gradients' on the CPU, and the card's state
   after each step (parameters, both moments) within rtol 1e-6 + 1e-6 x
   max of AdamW on the CPU from the card's state, synced gradients and
   norm;
21. train_encdec -- whisper-base untied, nothing cut (6 encoder + 6
   decoder layers, d 512, 8 heads, d_ff 2,048, vocab 51,865 padded to
   51,872, bf16) over M = 8, degrees (4, 2), the launcher's batch 8 x seq
   256 with 1,500 stub frames a row: the train phase's configurations and
   asserts (w = 512 on the sparse sync);
22. train_vlm -- internvl2-26b untied at full width with ``fsdp=True`` as
   published (d 6,144, 48 heads, kv 8, d_ff 16,384, vocab 92,553 padded
   to 92,560, bf16; VLM_LAYERS of its 48 layers) over M = 4, degrees (2,
   2), batch 8 x seq 256 text after 1,024 stub image tokens a row (T =
   1,280): ``hier``, sparse fused / banded (raw), fused ``delta``, then
   fused / raw again (no ``delta+int8ef``: its carry would be 4 x 92,560
   x 6,144 float32, 9.1 GB), the train phase's asserts (w = 6,144); then
   the FSDP pair at VLM_PAIR_LAYERS from the same weights, ``hier``:
   ``fsdp=True`` against ``False``, step-1 losses bit-equal, step 1's
   synced FSDP leaves within FSDP_PAIR_LIMITS, every other synced leaf
   bit-equal, both peaks;
23. serve -- ``ContinuousBatchingScheduler`` of qwen1.5-0.5b as published
   (tied, 24 layers, d 1,024, vocab 151,936, bf16) on 4 data positions,
   8 slots: 16 Zipf(1.2) requests of 512 tokens, ``max_new`` 32 (max_seq
   545); the sequential oracle, then the batched service with the sparse
   dispatch over the 4 positions for each (merge, wire) of sort / fused
   / banded raw and fused / banded ``delta+int8ef`` (the tail unions
   through rows 1-6), then the same stream at (data, model) = (2, 2) with
   fused raw (``serve_tp``); serve_moe -- granite-moe-3b-a800m as
   published but 16 of its 32 layers, at (2, 2), slots 4, 8 requests,
   fused dispatch and ``expert_load`` equal to the predictor's bincount;
   serve_ssm -- xlstm-1.3b as published but 16 of its 48 layers, 2
   positions, slots 4, 4 requests;
   serve_encdec -- whisper-base as published, the launcher's fixed batch
   of 4 rows with its cross cache.  Each holds (a) batched = oracle token
   for token (whisper: row 0's ids unchanged with the other rows
   replaced), (b) a decode after a prefill of S tokens against the
   prefill of S + 1 (xlstm: in float32, against the same on a CPU copy)
   within SERVE_REL_BOUND of max |logit|, a decode from an empty cache
   outside it, (c) every id <
   vocab, (d) one DtoH copy of slots x 4 bytes in a decode step's window
   (profiler trace, the dispatch outside it); prefill ms, decode ms a
   step, the kernels' device ms of a step, tokens/s, peak memory and the
   dispatch's plan hit rate;
24. serve_splitkv -- split-KV decode (``make_decode_step(...,
   seq_sharded=True)``) of qwen1.5-0.5b's swa variant on 4 data
   positions, one row of a 524,288-slot cache across the shard boundary,
   then the base variant at 32,768 slots, 4 rows; serve_2d -- the 2D
   weight-stationary decode (``serve2d=True``) of internvl2-26b at all 48
   layers at (2, 2); serve_2d_moe -- arctic-480b at 1 layer, float32;
   serve_2d_hybrid -- reduced jamba against a CPU copy.  Each step's
   logits within SERVE_REL_BOUND of the gather twin's, greedy ids equal
   where the margin clears it; ms a step, busy share and peak memory of
   both; no MoE copy dropped;
25. audit -- ``python -m repro_torch.analysis --audit``'s sweep on the
   card, every report clean (off the main path);
26. dryrun -- two 16 x 16 production-mesh pairs traced on meta tensors
   (``repro_torch.launch.dryrun``) and the memory model beside
   serve_2d's measured peak (host only);
27. kernels -- each kernel on the inputs it got on the main path (phases
   2-23, layer 0 / first round; the two merge-rank kernels at every shape
   the main path handed them, the replica stage's [64, 2, C] and the
   survivors' flat [62, 31, C] included, the dense scatter also at the
   replica stage and the survivor layer, the CSR SpMV at each graph
   phase, and the banded scatters at every (phase, butterfly layer, value
   dtype): f32, bf16 and int8 + scale, each
   with its main-path calls, its two CUDA launches and device ms per
   stage, a byte bound over what it must move (the kept sources, the
   window table and the output) and one over every ``pos`` entry, and
   its window table equal to ``searchsorted``), against its
   plain version (ranks exact, the banded kernel's own tile counts equal
   to ``rank_tile_stats`` summed over the layer-0 run pairs,
   scatters bit-exact on dyadic inputs else rtol 1e-6, the scaled banded
   scatter bit-exact against its plain version on a CPU copy, and
   repeatable;
   the dense scatter at the wire shape also bit-exact on general floats
   against its plain version on a CPU copy, with its layout equal to a
   stable argsort; the ELL SpMV rtol 1e-5; the CSR SpMV rtol 1e-5 on
   PageRank's first graph, and on the other graphs within 1e-5 x (|A|
   |x|) of the float64 product and 1e-4 x (|A| |x|) of the plain version,
   and repeatable; the union path's run compaction (``trim_runs``, no TPU
   kernel) at every (phase, shape) the main path handed it on the card,
   union_wire's [64, 64 x 131,072] to 2^22 first, bit for bit against its
   plain version (the former scan-and-scatter trim) and repeatable, its
   launches by phase and two CUDA launches a call; rows 1-6 also at
   every shape of the train phases --
   the rank rows in ``shapes`` with phase ``train``, ``train_tp``,
   ``train_tp_moe``, ``train_pod``, ``train_pod_tp``, ``train_long``
   (capacity 8,192), ``train_moe``, ``train_ssm``, ``train_encdec`` or
   ``train_vlm``, the scatter rows in
   ``train``, w = 512, 1,024, 1,536, 2,048 or 6,144 values a row of
   general floats, bit for bit
   against the plain version on a CPU copy, with their launches a step,
   byte bound and ``index_add_`` time), and at the serve dispatch's tail
   unions (the rank rows in ``shapes`` with phase ``serve``,
   ``serve_tp`` or ``serve_moe``, the dense scatters in ``serve``, the
   banded ones in ``shapes``: counts of width 1, launches a dispatch
   step), with
   CUDA-event times of kernel, plain version and the nearest single
   PyTorch call, and the least time the card needs.  The ELL kernel, off
   the main path now, is held to its plain version on ELL tables built
   for that row alone from the same graph.

The graph phases (4-7, 15, 16) run every ``GraphEngine.run`` as one CUDA
graph replay: each line carries ``graph`` readings (:func:`graph_check`:
the replay against the engine's eager loop bit for bit, host seconds a
round of each, one graph launch a run, and :func:`replay_kernels`:
profiler traces of replays, in this process and taken again unless
whole, hold every kernel launch the capture enqueued, once a replay,
while no kernel wrapper is called), PageRank's also the rotated
schedule's engine (``overlap=True``) bit for bit against the plain one.
The SpMV wrapper counts an entry point's warm-up round and the rounds
its capture enqueues; the kernels line's SpMV launches are what ran: the
warm-up rounds, and the main path's replays times a traced replay's SpMV
kernels.

The other launch counts of the ``kernels`` line are those of the
main-path calls alone (``config`` + ``reduce``, the first ``union_reduce`` of each
(merge, wire), the ``pagerank``, ``hadi`` and ``power_iteration`` entry
points, the supervised reduces and engine runs, each train
configuration's steps): each starts with every
count at 0 and is read right after, before any timing loop runs.  The
soak's kernels run in its subprocesses, which print their own counts
(the soak_resume line).  Each phase starts from an empty plan cache (a
directory of its own under the run's temporary root, removed at exit)
and an empty memo, so its config times are those of a fresh config
unless its line says otherwise (``config_cache``).  Profiler traces
(union_wire's and the kernels line's device ms and CUDA launches per
call) are taken in a fresh process that shares the tensors through CUDA
IPC; the ``profiler`` line counts its calls and traces.
The ``main_path_launches`` line carries each phase's seconds and the
``timing`` line the kernels line's and the whole run's.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU;
exits non-zero without one or outside a checkout of the repository.
"""
import contextlib
import dataclasses
import json
import math
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
DEVICE = "cuda"
M, DEGREES = 64, (16, 4)
N_VERTICES, N_EDGES, ROUNDS, DAMPING = 262_144, 2_000_000, 10, 0.85
LARGE_VERTICES, LARGE_EDGES = 1_048_576, 10_000_000
UNION_C, UNION_RANGE, UNION_ALPHA = 16_384, 1 << 22, 1.4
WIRE_DRAWS, WIRE_C, WIRE_RANGE, WIRE_ALPHA = 262_144, 131_072, 1 << 24, 1.1
MERGES = ("sort", "fused", "banded")
HADI_HOPS, HADI_BITS, HADI_TRIALS = 16, 24, 4
SPECTRAL_ITERS = 30
REPLICATION = 2
REP_UNION_NODES, REP_UNION_DEGREES = 32, (8, 4)
# supervised PageRank and the soak: M partitions over a pool of POOL
# positions, a rack of RACK positions lost from round FAULT_AT on
POOL, RACK, FAULT_AT, CKPT_EVERY = 80, 5, 3, 2
# the decode layouts: DECODE_STEPS greedy steps each.  serve_splitkv:
# qwen1.5-0.5b's swa variant on 4 data positions, one row of a 524,288-slot
# cache from pos 131,064 (the shard boundary at 131,072), then the base
# variant at 32,768 slots, 4 rows; serve_2d: internvl2-26b at (2, 2);
# serve_2d_moe: arctic-480b at 1 of its 35 layers at (2, 2)
DECODE_STEPS = 16
# "drop": the control's zeroed slots -- the window before the first token
# (shard 0's share of it), and shard 1 of 4; "fill": the cache's (k, v)
# scales, 0.3 (tools/splitkv_fill_probe.py: at the reference test's 0.1 a
# zeroed shard reads barely over SERVE_REL_BOUND, at 1.0 the layouts'
# bf16 difference comes near it)
SPLITKV = {"variant": "swa", "data": 4, "rows": 1, "slots": 524288,
           "pos": [131064], "drop": (131064 - 4095, 131064),
           "fill": (0.3, 0.3)}
SPLITKV_BASE = {"variant": "base", "data": 4, "rows": 4, "slots": 32768,
                "pos": [32744, 32736, 32728, 32720], "drop": (8192, 16384),
                "fill": (0.3, 0.3)}
SERVE2D = {"arch": "internvl2-26b", "data": 2, "tp": 2, "rows": 4,
           "prompt": 64, "max_seq": 2048}
SERVE2D_MOE = {"arch": "arctic-480b", "data": 2, "tp": 2, "rows": 4,
               "prompt": 64, "max_seq": 256, "layers": 1}
# serve_2d's measured peak, which the dryrun phase prints beside the model
LAYOUT_PEAKS = {}
# the dryrun phase's production-mesh pairs: (arch, shape, serve2d)
DRYRUN_PAIRS = (("qwen1.5-0.5b", "decode_32k", False),
                ("command-r-plus-104b", "decode_32k", True))
# the phases whose recorded kernel inputs make up the shapes of a row, in
# the order the rows list them
ROW_PHASES = ("union_wire", "replicated_union", "resilient_union", "union",
              "train", "train_tp", "train_tp_moe", "train_pod",
              "train_pod_tp", "train_long", "train_moe", "train_ssm",
              "train_encdec", "train_vlm", "serve", "serve_tp", "serve_moe")
GRAPH_PHASES = ("pagerank", "spectral", "pagerank_large",
                "supervised_pagerank")
# each graph phase's SpMV kernels run on its main path: the warm-up
# rounds' launches, and its graph replays times the kernels a traced
# replay of the same graph ran (:func:`replay_kernels`)
GRAPH_RAN = {}
# the sparse steps each phase ran by (phase, merge, int8 wire): a train
# phase's sparse syncs and a serve phase's dispatch steps
MERGE_STEPS = {}
# phases whose scatter calls are told apart by shape (one per layer)
SHAPED_SCATTER_PHASES = ("resilient_union", "train", "train_tp",
                         "train_tp_moe", "train_pod", "train_pod_tp",
                         "train_long", "train_moe", "train_ssm",
                         "train_encdec", "train_vlm", "serve", "serve_tp",
                         "serve_moe")
WIRES = ("raw", "delta", "delta+bf16", "delta+int8ef")
# the train phase: qwen1.5-0.5b untied at full width on M = 8 stacked
# data positions, degrees (4, 2), the launcher's batch 8 x seq 256
TRAIN_ARCH, TRAIN_M, TRAIN_DEGREES = "qwen1.5-0.5b", 8, (4, 2)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 3
TRAIN_CONFIGS = (("hier", "sort", "raw"), ("sparse", "sort", "raw"),
                 ("sparse", "fused", "raw"), ("sparse", "banded", "raw"),
                 ("sparse", "fused", "delta"),
                 ("sparse", "fused", "delta+int8ef"),
                 ("sparse", "banded", "delta+int8ef"))
# every train phase ends with fused / raw again, bit for bit the first
REPEAT = ("sparse", "fused", "raw")
# train_moe: granite-moe-3b-a800m untied at full width (MOE_LAYERS of 32,
# the memory reckoning's cut being 24) on M = 2 positions of 1,024 tokens
MOE_ARCH, MOE_M, MOE_DEGREES, MOE_LAYERS = "granite-moe-3b-a800m", 2, (2,), 32
MOE_CONFIGS = (("hier", "sort", "raw"), ("sparse", "sort", "raw"),
               ("sparse", "fused", "raw"), ("sparse", "banded", "raw"),
               ("sparse", "fused", "delta+int8ef"),
               ("sparse", "banded", "delta+int8ef"))
# train_ssm: xlstm-1.3b untied at full width, SSM_LAYERS of its 48 (whole
# periods of 7 mLSTM + 1 sLSTM; cut to keep the smoke well inside its
# time limit: its steps are launch-bound), on M = 8 (SSM_STEPS a configuration: its steps take
# seconds), then reduced jamba on M = 4, replayed on the CPU
SSM_ARCH, SSM_M, SSM_DEGREES, SSM_STEPS = "xlstm-1.3b", 8, (4, 2), 2
SSM_LAYERS = 8
SSM_CONFIGS = (("hier", "sort", "raw"), ("sparse", "fused", "raw"),
               ("sparse", "banded", "raw"),
               ("sparse", "fused", "delta+int8ef"),
               ("sparse", "banded", "delta+int8ef"))
HYBRID_ARCH, HYBRID_M, HYBRID_DEGREES = "jamba-1.5-large-398b", 4, (2, 2)
# train_encdec: whisper-base untied, nothing cut, on M = 8, degrees (4, 2)
ENCDEC_ARCH, ENCDEC_M, ENCDEC_DEGREES = "whisper-base", 8, (4, 2)
# train_vlm: internvl2-26b untied at full width, fsdp=True as published,
# VLM_LAYERS of its 48 layers on M = 4, degrees (2, 2); the FSDP pair at
# VLM_PAIR_LAYERS
VLM_ARCH, VLM_M, VLM_DEGREES = "internvl2-26b", 4, (2, 2)
VLM_LAYERS, VLM_PAIR_LAYERS = 4, 2
VLM_CONFIGS = (("hier", "sort", "raw"), ("sparse", "fused", "raw"),
               ("sparse", "banded", "raw"), ("sparse", "fused", "delta"))
# the FSDP pair's synced FSDP leaves (the positions summed in bfloat16 by
# the gather's backward against the float32 butterfly): max |a - b| over
# max |b|, and ||a - b|| / ||b||; 4 and 2 bfloat16 unit roundoffs (2^-8),
# set on the CPU test (tests/test_torch_fsdp.py: at most 0.0071 and
# 0.0031 there)
FSDP_PAIR_LIMITS = {"max_rel": 2.0 ** -6, "l2_rel": 2.0 ** -7}
# train_tp: the model axis.  qwen1.5-0.5b untied at full width on TP_M x
# TP_TP (data x model), degrees TP_DEGREES of the data axis; then
# granite-moe-3b-a800m untied at full width on TP_MOE_M x TP_TP (its
# recorder phase "train_tp_moe"), and reduced granite's three hier steps
# on the card replayed on the CPU (TP_REPLAY)
TP_ARCH, TP_M, TP_TP, TP_DEGREES = "qwen1.5-0.5b", 4, 2, (2, 2)
TP_CONFIGS = (("hier", "sort", "raw"), ("sparse", "sort", "raw"),
              ("sparse", "fused", "raw"), ("sparse", "banded", "raw"),
              ("sparse", "fused", "delta+int8ef"),
              ("sparse", "banded", "delta+int8ef"))
TP_MOE_M, TP_MOE_DEGREES, TP_MOE_LAYERS = 2, (2,), 32
TP_MOE_CONFIGS = (("hier", "sort", "raw"), ("sparse", "fused", "raw"))
TP_REPLAY = {"arch": MOE_ARCH, "variant": "untied", "m": 2, "tp": 2,
             "degrees": (2,)}
# qwen at (TP_M, TP_TP) against the same weights at (TP_M, 1), one hier
# step in bfloat16, held leaf by leaf (:func:`excess`: rtol, atol as a
# multiple of the leaf's own max |tp = 1 value|): the step-1 loss |a - b|
# / |b|; every synced gradient leaf; every leaf's update (parameters
# after the step minus before) on the elements whose sign the gradient
# bound fixes.  Leaves in TP_PAIR_ZERO_GRAD have a true gradient of 0 by
# construction and sync rounding noise, so they are left out by that
# rule.  2^-6 is four bfloat16 unit roundoffs of the leaf's max; set
# before the card's first run of this form (the tp = 2 forward takes the
# products tp = 1 takes, apart from attention's per-position batch)
TP_PAIR_LIMITS = {"loss": 2.0 ** -10, "grads": (2.0 ** -6, 2.0 ** -6),
                  "update": (2.0 ** -6, 2.0 ** -6)}
# the key bias: softmax over the keys is invariant to q . bk, which is the
# same for every key of a query
TP_PAIR_ZERO_GRAD = ("bk",)
# train_pod: qwen at (pod, data, model) = (2, 2, 1) with degrees {pod:
# (2,), data: (2,)} against (4, 1) with {data: (2, 2)}, and (2, 2, 2)
# against (4, 2) (recorder phase "train_pod_tp"), POD_STEPS steps each
# from the same weights: losses, step-1 synced gradients and the
# parameters after, bit for bit
POD, POD_DATA, POD_STEPS = 2, 2, 2
POD_CONFIGS = (("hier", "sort", "raw"), ("sparse", "fused", "raw"),
               ("sparse", "banded", "delta+int8ef"))
POD_TP_CONFIGS = (("hier", "sort", "raw"), ("sparse", "fused", "raw"))
# train_long: qwen on M = 2 positions of one 8,192-token row each (the
# query-chunked attention), LONG_STEPS steps a configuration
LONG_M, LONG_BATCH, LONG_SEQ, LONG_STEPS = 2, 2, 8192, 2
LONG_CONFIGS = (("hier", "sort", "raw"), ("sparse", "fused", "raw"))
# train_overlap: qwen as the train phase (M = 8, degrees (4, 2)), hier
# with the bucketed schedule (the default 4 MB budget) against off,
# OVERLAP_STEPS steps from the same weights, bit for bit
OVERLAP_STEPS = 3
# serve: qwen1.5-0.5b as published (tied) on SERVE_M stacked data
# positions with SERVE_SLOTS slots, SERVE_REQUESTS Zipf(1.2) requests of
# SERVE_PROMPT tokens and max_new SERVE_GEN; the sparse dispatch over the
# positions for each (merge, wire) of SERVE_DISPATCH, then the same stream
# at (data, model) = SERVE_TP with SERVE_TP_DISPATCH (recorder phase
# "serve_tp")
SERVE_ARCH, SERVE_M, SERVE_SLOTS = "qwen1.5-0.5b", 4, 8
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 16, 512, 32
SERVE_DISPATCH = (("sort", "raw"), ("fused", "raw"), ("banded", "raw"),
                  ("fused", "delta+int8ef"), ("banded", "delta+int8ef"))
SERVE_TP, SERVE_TP_DISPATCH = (2, 2), ("fused", "raw")
# serve_moe, serve_ssm, serve_encdec: the published configs, granite's and
# xlstm's at "layers" of their 32 and 48 (the host-bound decode's time)
SERVE_MOE = {"arch": MOE_ARCH, "data": 2, "tp": 2, "requests": 8,
             "slots": 4, "prompt": 256, "gen": 16, "layers": 16}
SERVE_SSM = {"arch": SSM_ARCH, "data": 2, "tp": 1, "requests": 4,
             "slots": 4, "prompt": 256, "gen": 16, "layers": 16}
SERVE_ENCDEC = {"arch": ENCDEC_ARCH, "data": 2, "rows": 4, "prompt": 64,
                "gen": 16}
# (b): what a decode after a prefill of S tokens is held to, and in which
# torch dtype (None: the config's): "prefill", the prefill of S + 1 on the
# card; "cpu", the same prefill and decode on a CPU copy.  xlstm-1.3b's
# longer prefill is not the decode's function (the reference's chunkwise
# mLSTM normaliser, ROADMAP Queue 3), and its bf16 forward at seed-0
# weights is too ill-conditioned for any reference (the card and the CPU
# differ by ~0.6 of max |logit|), so its decode is held in float32 to
# the CPU's; the bf16 readings of SERVE_PRINTOUTS are printed only
SERVE_CONSISTENCY = {SERVE_ARCH: ("prefill", None),
                     MOE_ARCH: ("prefill", None),
                     SSM_ARCH: ("cpu", "float32"),
                     ENCDEC_ARCH: ("prefill", None)}
SERVE_PRINTOUTS = {SSM_ARCH: (("prefill", None), ("cpu", None))}
# the bound on max |logit difference| / max |logit| for every arch: ~3x
# the largest bf16 / float32 reading on an H100 (1.5e-2, qwen at (2, 2)),
# ~25x below the smallest reading of a decode from an empty cache (1.3)
SERVE_REL_BOUND = 5e-2
# the least share of (step, row) pairs whose tokens a bf16 MoE layout and
# its gather twin route alike (layout_pair's ``routes``)
ROUTE_SHARE = 0.75
# serve_moe's (b) prompt: the longer prefill's 8 tokens a data position
# drop nothing, as the decode does not (at 32 tokens and more the Zipf
# prompt's repeated tokens overflow an expert, and the prefill is another
# function)
SERVE_MOE_CONSISTENCY_PROMPT = 7
# the serve phases whose dispatch runs the union path's kernels
SERVE_PHASES = ("serve", "serve_tp", "serve_moe")
# the train phases whose sparse syncs run the union path's kernels
TRAIN_PHASES = ("train", "train_tp", "train_tp_moe", "train_pod",
                "train_pod_tp", "train_long", "train_moe", "train_ssm",
                "train_encdec", "train_vlm")


def emit(obj) -> None:
    """One JSON line on stdout."""
    print(json.dumps(obj), flush=True)


# the phase the main path is in, read by the Recorders' keys, and whether
# a main-path call is running (the Recorders count only those calls)
PHASE = {"name": None, "main": False}


def main_path(call):
    """``(call(), launches)``: the kernels' launch counts of this one
    main-path call, zeroed just before it and read just after."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    PHASE["main"] = True
    try:
        out = call()
    finally:
        PHASE["main"] = False
    return out, dict(_build.LAUNCHES)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_tree(torch, a, b) -> bool:
    """Two run results (tensors in tuples, lists and dicts, or None)
    bit for bit equal."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(same_tree(torch, a[k], b[k])
                                              for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(torch, x, y)
                                        for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


def graph_check(torch, engine, k, state, extras, reps=5):
    """``engine.run(k)`` -- one CUDA graph replay a run -- against the
    engine's eager loop (``eager_fn``) on the same inputs: final state,
    last product bit for bit.  Host-clock seconds a round of each (the
    median of ``reps`` runs after a warm one, each ending in a
    synchronize), the graph launches per run and the captures, and the
    kernels of one replay (:func:`replay_kernels`).  Returns
    ``(readings, the graph's result)``."""
    eager = engine.eager_fn(k)

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times)) / k, times
    runs0 = engine.report["dispatches"]
    launches0 = engine.report["graph_launches"]
    got, graph_s, graph_times = timed(lambda: engine.run(k, state, extras))
    want, eager_s, _ = timed(lambda: eager(state, extras))
    assert same_tree(torch, got, want), "graph replay differs from eager"
    runs = engine.report["dispatches"] - runs0
    per_run = (engine.report["graph_launches"] - launches0) / runs
    assert per_run == 1, (per_run, engine.report)
    captures = engine.report["captures"]
    replay = replay_kernels(torch, engine, k, state, extras)
    return {"round_wall_s": graph_s, "eager_round_wall_s": eager_s,
            "run_wall_s": graph_times, "graph_vs_eager_bit_identical": True,
            "graph_launches_per_run": per_run, "captures": captures,
            "overlap": engine.overlap, **replay}, got


def replay_kernels(torch, engine, k, state, extras, reps=5):
    """The kernels one replay of ``engine``'s k-round graph runs on the
    device, from ``torch.profiler`` traces of ``reps`` runs
    (:func:`profile_kernels`: a trace is taken again unless every kernel
    ran a whole number of times a run): every kernel launch the capture
    enqueued (``captured_launches``, by wrapper) ran once a replay, no
    kernel wrapper was called and nothing was captured again.  Returns
    ``captured_launches``, ``replay_kernels`` (launches a replay by
    device function), ``replay_device_ms`` (their device ms, summed) and
    ``replay_spmv`` (the SpMV kernel's launches a replay)."""
    from repro_torch.kernels import _build
    captures, wrapped = engine.report["captures"], dict(_build.LAUNCHES)
    stages = profile_kernels(torch, lambda: engine.run(k, state, extras),
                             reps)
    captured = engine.run_fn(k).launches
    ran = {name: n for name, (_, n) in stages.items()}
    assert engine.report["captures"] == captures, engine.report
    assert dict(_build.LAUNCHES) == wrapped, "a replay called a wrapper"
    assert set(captured) <= {"spmv_csr"}, captured
    assert ran.get("spmv_csr_kernel", 0) == captured.get("spmv_csr", 0), \
        (captured, ran)
    return {"captured_launches": captured, "replay_kernels": ran,
            "replay_device_ms": sum(ms for ms, _ in stages.values()),
            "replay_spmv": ran.get("spmv_csr_kernel", 0)}


class Recorder:
    """Wraps a kernel wrapper where the main path looks it up and keeps
    the arguments of its first main-path call of each variant (``key(args,
    kwargs)``), i.e. the layer-0 / first-round inputs of that variant,
    and the number of main-path calls of each variant."""

    def __init__(self, module, name, key=lambda args, kwargs: "first"):
        self.module, self.name, self.key = module, name, key
        self.fn = getattr(module, name)
        self.args, self.calls = {}, {}
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if PHASE["main"]:
            key = self.key(args, kwargs)
            self.args.setdefault(key, (args, kwargs))
            self.calls[key] = self.calls.get(key, 0) + 1
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)

    def move(self, device) -> int:
        """Copies every recorded call's tensors to ``device`` (see
        :func:`move_storages`); returns the bytes copied."""
        seen = {}
        self.args = {k: move_storages(v, device, seen)
                     for k, v in self.args.items()}
        return sum(st.nbytes() for st in seen.values())


def move_storages(obj, device, seen):
    """``obj`` (tensors in tuples, lists and dicts) with each tensor not
    yet on ``device``'s type rebuilt on a copy of its whole storage there,
    with the same offset, sizes and strides; tensors that share a storage
    share its one copy (``seen``, by the source storage).  Between phases
    the recorded inputs wait on the host: on the card they took 8.7-9.3
    GB that the later train phases need (internvl2's peak 69.1 GiB of
    79.2)."""
    import torch
    if isinstance(obj, dict):
        return {k: move_storages(v, device, seen) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(move_storages(v, device, seen) for v in obj)
    if not isinstance(obj, torch.Tensor) or \
            obj.device.type == torch.device(device).type:
        return obj
    src = obj.untyped_storage()
    key = (src.device, src.data_ptr())
    if key not in seen:
        seen[key] = src.to(device=device)
    return torch.empty(0, dtype=obj.dtype, device=seen[key].device).set_(
        seen[key], obj.storage_offset(), obj.size(), obj.stride())


def scatter_variant(args, kwargs):
    """Recorder key of a scatter call: the phase, and ``scaled`` or the
    value dtype."""
    if kwargs.get("scale") is not None:
        key = PHASE["name"], "scaled"
    else:
        key = PHASE["name"], "bf16" if args[1].dtype.itemsize == 2 else "f32"
    if PHASE["name"] in SHAPED_SCATTER_PHASES:
        key += (tuple(args[0].shape),)
    return key


def banded_variant(args, kwargs):
    """Recorder key of a banded scatter call: the phase, the dtype and the
    positions' shape (each butterfly layer hands the kernel its own)."""
    return scatter_variant(args, kwargs)[:2] + (tuple(args[0].shape),)


def rank_variant(args, kwargs):
    """Recorder key of a merge-rank call: the phase, the kernel and the
    runs' shape (each butterfly layer hands the kernels its own)."""
    return (PHASE["name"], "banded" if kwargs.get("banded") else "dense",
            tuple(args[0].shape))


def trim_variant(args, kwargs):
    """Recorder key of a run-compaction call: the phase, the device type
    (a CPU call runs the plain version and launches nothing), the index
    and value shapes, the value dtype, the run length and the capacity."""
    idx, val, run, cap = args
    return (PHASE["name"], idx.device.type, tuple(idx.shape),
            tuple(val.shape), str(val.dtype), run, cap)


def phase_planned(torch, parts):
    """Planned reduce on the PageRank index sets vs the float64 sim."""
    from repro_torch.core.api import SparseAllreduce
    out_sets = [p.out_idx.astype(np.uint32) for p in parts]
    in_sets = [p.in_idx.astype(np.uint32) for p in parts]
    rng = np.random.RandomState(1)
    values = [rng.randn(len(o)).astype(np.float32) for o in out_sets]
    dev = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE)
    t0 = time.perf_counter()
    _, config_launches = main_path(lambda: dev.config(out_sets, in_sets))
    config_s = time.perf_counter() - t0
    got, launches = main_path(lambda: dev.reduce(values))
    launches = {k: v + config_launches[k] for k, v in launches.items()}
    # the down half's sums run in a fixed order: repeats give equal bits
    for _ in range(2):
        assert all(np.array_equal(a, b) for a, b in
                   zip(dev.reduce(values), got)), "planned reduce repeat"
    sim = SparseAllreduce(M, DEGREES, backend="sim")
    sim.config(out_sets, in_sets)
    want = sim.reduce(values)
    err = 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        err = max(err, float(np.max(np.abs(g - w), initial=0.0)))
    planned, _ = dev.planned_parts()
    routing = planned.device_args(DEVICE)
    staged = torch.zeros((M, planned.u_cap), device=DEVICE)
    reduce_ms = cuda_ms(lambda: dev.reduce_fn(staged), reps=10)
    emit({"phase": "planned", "ok": True, "max_abs_err": err,
          "tolerance": "rtol 1e-5, atol 1e-5 vs float64 sim; three reduces "
                       "of the same normal floats bit-identical",
          "config_s": config_s, "config_cache": dev.config_cache,
          "u_cap": planned.u_cap, "uin_cap": planned.uin_cap,
          "q_cap": planned.q_cap,
          "sum_fans": [routing.user_scatter.fan]
          + [layer[2].fan for layer in routing.layers],
          "reduce_ms": reduce_ms, "launches": launches})
    return launches


def union_inputs():
    """[M, C] hashed sorted SENTINEL-padded indices + dyadic values."""
    from repro_torch.core.sparse_vec import SENTINEL, HashPerm
    rng = np.random.RandomState(2)
    perm = HashPerm.make(3)
    idx = np.full((M, UNION_C), SENTINEL, np.int64)
    val = np.zeros((M, UNION_C), np.float32)
    all_h, all_v = [], []
    for n in range(M):
        raw = (rng.zipf(UNION_ALPHA, UNION_C) - 1) % UNION_RANGE
        h = perm.fwd_np(raw.astype(np.uint32)).astype(np.int64)
        v = rng.randint(-8, 9, UNION_C).astype(np.float64) / 1024
        u, inv = np.unique(h, return_inverse=True)
        s = np.zeros(len(u))
        np.add.at(s, inv, v)
        idx[n, : len(u)] = u
        val[n, : len(u)] = s
        all_h.append(u)
        all_v.append(s)
    want_idx, inv = np.unique(np.concatenate(all_h), return_inverse=True)
    want_val = np.zeros(len(want_idx))
    np.add.at(want_val, inv, np.concatenate(all_v))
    return idx, val, want_idx, want_val


def phase_union(torch):
    """Union reduce, fused vs sort vs numpy dense oracle."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    idx, val, want_idx, want_val = union_inputs()
    out_cap = shape_bucket(len(want_idx))
    res, ms, launches = {}, {}, {}
    for merge in ("sort", "fused"):
        ar = SparseAllreduce(M, DEGREES, backend="device", merge=merge,
                             device=DEVICE)
        ti = torch.as_tensor(idx, device=DEVICE)
        tv = torch.as_tensor(val, device=DEVICE)
        res[merge], launches[merge] = main_path(
            lambda: ar.union_reduce(ti, tv, out_cap))
        ms[merge] = cuda_ms(lambda: ar.union_reduce(ti, tv, out_cap), reps=3,
                            warmup=1)
    (si, sv, so), (fi, fv, fo) = res["sort"], res["fused"]
    assert torch.equal(si, fi) and torch.equal(so, fo), "fused != sort (idx)"
    assert torch.equal(sv, fv), "fused != sort (values)"
    assert int(fo.sum()) == 0, f"overflow {fo.tolist()}"
    n = len(want_idx)
    oi, ov = fi.cpu().numpy(), fv.cpu().numpy()
    assert np.array_equal(oi[:, :n], np.broadcast_to(want_idx, (M, n)))
    assert np.all(oi[:, n:] == 0xFFFFFFFF)
    assert np.array_equal(ov[:, :n].astype(np.float64),
                          np.broadcast_to(want_val, (M, n)))
    emit({"phase": "union", "ok": True, "union_count": n,
          "out_capacity": out_cap, "fused_equals_sort": True,
          "max_abs_err": 0.0, "sort_ms": ms["sort"], "fused_ms": ms["fused"],
          "layers": len(DEGREES), "launches": launches})
    return {k: launches["sort"][k] + launches["fused"][k]
            for k in launches["fused"]}


def union_wire_inputs(nodes=None):
    """[nodes, WIRE_C] hashed sorted coalesced indices of WIRE_DRAWS Zipf
    draws per node, values ``randint(-8, 9) / 1024`` summed per index, and
    the float64 union oracle (fewer nodes: the first ones of the same
    draws)."""
    from repro_torch.core.sparse_vec import SENTINEL, HashPerm
    nodes = nodes or M
    rng = np.random.RandomState(5)
    perm = HashPerm.make(6)
    idx = np.full((nodes, WIRE_C), SENTINEL, np.int64)
    val = np.zeros((nodes, WIRE_C), np.float32)
    all_h, all_v = [], []
    for n in range(nodes):
        raw = (rng.zipf(WIRE_ALPHA, WIRE_DRAWS) - 1) % WIRE_RANGE
        h = perm.fwd_np(raw.astype(np.uint32)).astype(np.int64)
        v = rng.randint(-8, 9, WIRE_DRAWS).astype(np.float64) / 1024
        u, inv = np.unique(h, return_inverse=True)
        s = np.bincount(inv, weights=v)
        assert len(u) <= WIRE_C, (n, len(u))
        idx[n, : len(u)] = u
        val[n, : len(u)] = s
        all_h.append(u)
        all_v.append(s)
    want_idx, inv = np.unique(np.concatenate(all_h), return_inverse=True)
    vals = np.concatenate(all_v)
    # every partial f32 sum of these multiples of 2^-10 is exact
    assert np.bincount(inv, weights=np.abs(vals)).max() < 2.0 ** 14
    want_val = np.bincount(inv, weights=vals)
    return idx, val, want_idx, want_val


def phase_union_wire(torch):
    """Union reduce at mini-batch scale for every (merge, wire) pair."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.sparse_vec import SENTINEL
    t0 = time.perf_counter()
    idx, val, want_idx, want_val = union_wire_inputs()
    inputs_s = time.perf_counter() - t0
    n = len(want_idx)
    out_cap = shape_bucket(n)
    torch.cuda.reset_peak_memory_stats()
    ti = torch.as_tensor(idx, device=DEVICE)
    tv = torch.as_tensor(val, device=DEVICE)
    want_i = torch.as_tensor(want_idx, device=DEVICE).expand(M, n)
    want_v = torch.as_tensor(want_val.astype(np.float32),
                             device=DEVICE).expand(M, n)
    amax = float(np.abs(want_val).max())
    first, pairs, total = {}, [], {}
    for wire in WIRES:
        for merge in MERGES:
            ar = SparseAllreduce(M, DEGREES, backend="device", merge=merge,
                                 wire=wire, device=DEVICE)
            (oi, ov, of), launches = main_path(
                lambda: ar.union_reduce(ti, tv, out_cap))
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            assert int(of.sum()) == 0, (merge, wire, of.tolist())
            assert torch.equal(oi[:, :n], want_i), (merge, wire, "idx")
            assert bool((oi[:, n:] == SENTINEL).all()), (merge, wire)
            got = ov[:, :n]
            err = float((got - want_v).abs().max())
            if wire in ("raw", "delta"):
                assert torch.equal(got, want_v), (merge, wire, err)
            elif wire in first:
                gap = float((got - first[wire]).abs().max())
                bound = 0.0 if wire == "delta+bf16" else 1e-5 * amax
                assert gap <= bound, (merge, wire, gap, bound)
            else:
                first[wire] = got.clone()
            if wire == "delta+int8ef":
                assert err <= 0.05 * amax, (merge, wire, err, amax)
            del oi, ov, of, got
            ms = cuda_ms(lambda: ar.union_reduce(ti, tv, out_cap), reps=3,
                         warmup=1)
            pairs.append({"merge": merge, "wire": wire, "ms": ms,
                          "max_abs_err": err,
                          "launches": {k: v for k, v in launches.items()
                                       if v}})
    peak = torch.cuda.max_memory_allocated()
    # where a reduce's device time goes, by kernel (profiler); the cache is
    # released first, for the profiler's process allocates a reduce's own
    torch.cuda.empty_cache()
    with fresh_profiler():
        for entry in pairs:
            if entry["wire"] == "raw" and entry["merge"] != "sort":
                stages = fresh_profile(
                    ("repro_torch.core.api", "SparseAllreduce",
                     {"num_nodes": M, "degrees": DEGREES, "backend": "device",
                      "merge": entry["merge"], "wire": "raw",
                      "device": DEVICE}, "union_reduce"),
                    (ti, tv, out_cap), reps=2)
                entry["device_ms"] = sum(m for m, _ in stages.values())
                entry["top_kernels_ms"] = dict(sorted(
                    ((k, m) for k, (m, _) in stages.items()),
                    key=lambda kv: -kv[1])[:12])
    banded_i8 = next(p["launches"] for p in pairs
                     if p["merge"] == "banded" and p["wire"] == "delta+int8ef")
    assert banded_i8 == {"rank_counts_banded": len(DEGREES),
                         "banded_onehot_scatter_add_scaled": len(DEGREES),
                         "trim_runs": 1}, banded_i8
    emit({"phase": "union_wire", "ok": True, "union_count": n,
          "out_capacity": out_cap, "in_capacity": WIRE_C,
          "draws_per_node": WIRE_DRAWS,
          "valid_per_node_mean": float((idx != SENTINEL).sum(1).mean()),
          "max_abs_union": amax, "inputs_s": inputs_s,
          "max_memory_allocated": int(peak), "pairs": pairs,
          "tolerance": "idx exact; raw/delta exact vs float64; bf16 equal "
                       "across merges; int8ef merges within 1e-5 x max, "
                       "each within 0.05 x max of exact"})
    del first, ti, tv, want_i, want_v
    return total


def phase_pagerank(torch, edges, parts, n_vertices):
    """PageRank through the device entry point vs the float64 reference
    (one graph launch, after the capture's warm-up round), then the
    engine's wall time per round, its graph replay against its eager loop
    (:func:`graph_check`), and the rotated schedule's engine against the
    plain one."""
    from repro_torch.graph.engine import GraphEngine
    from repro_torch.graph.pagerank import (make_pagerank_app, pagerank,
                                            pagerank_dense_reference,
                                            pagerank_state)
    t0 = time.perf_counter()
    ref = pagerank_dense_reference(edges, n_vertices, iters=ROUNDS,
                                   damping=DAMPING)
    reference_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (got, stats), launches = main_path(lambda: pagerank(
        edges, n_vertices, m=M, degrees=DEGREES, iters=ROUNDS,
        damping=DAMPING, backend="device", device=DEVICE))
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-10)
    rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    # the wrapper: the capture's warm-up round, then the ROUNDS rounds it
    # enqueues into the graph (the replay calls no wrapper)
    assert launches["spmv_csr"] == ROUNDS + GraphEngine.WARMUP_ROUNDS \
        and launches["spmv_ell"] == 0, launches
    assert stats["engine"]["graph_launches"] == \
        stats["engine"]["dispatches"] == 1, stats["engine"]
    fresh_plan_cache()      # time a fresh config, as the entry point's
    t0 = time.perf_counter()
    app, out_sets, in_sets = make_pagerank_app(parts, n_vertices, DAMPING)
    engine = GraphEngine(out_sets, in_sets, app, degrees=DEGREES,
                         device=DEVICE)
    config_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    extras, p0 = pagerank_state(parts, n_vertices, engine.u_cap,
                                engine.uin_cap, device=DEVICE)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    first = engine.run(ROUNDS, p0, extras)
    graph, (state, last_q, _) = graph_check(torch, engine, ROUNDS, p0,
                                            extras)
    GRAPH_RAN[PHASE["name"]] = GraphEngine.WARMUP_ROUNDS + \
        stats["engine"]["graph_launches"] * graph["replay_spmv"]
    assert same_tree(torch, first, (state, last_q, None)), \
        "two PageRank runs differ"
    rotated = GraphEngine(out_sets, in_sets, app, degrees=DEGREES,
                          device=DEVICE, overlap=True)
    rot, out = graph_check(torch, rotated, ROUNDS, p0, extras)
    assert same_tree(torch, out, (state, last_q, None)), \
        "rotated schedule differs from plain"
    rot["bit_identical_to_plain"] = True
    del rotated, out, first
    csr_bytes = sum(int(t.numel() * t.element_size())
                    for t in extras.values())
    emit({"phase": PHASE["name"], "ok": True, "vertices": n_vertices,
          "edges": int(len(edges)), "nodes": M, "degrees": list(DEGREES),
          "rounds": ROUNDS, "max_abs_err": float(np.max(np.abs(got - ref))),
          "max_rel_err": rel, "tolerance": "rtol 1e-4 vs float64 dense",
          "csr_nnz": int(extras["cols"].numel()),
          "csr_rows": int(extras["row_ptr"].numel() - 1),
          "csr_bins": int(extras["bins"].numel() - 1),
          "csr_bytes": csr_bytes, "u_cap": engine.u_cap,
          "uin_cap": engine.uin_cap,
          "max_memory_allocated": int(peak),
          "max_memory_over_call": int(peak - base),
          "memory_allocated_before": int(base), "entry_point_s": total_s,
          "host_config_s": config_s, "config_cache": engine.config_cache,
          "csr_state_s": state_s, "reference_s": reference_s,
          "round_wall_s": graph["round_wall_s"],
          "two_runs_bit_identical": True, "graph": graph,
          "overlap_engine": rot, "engine": stats["engine"],
          "launches": launches})
    del engine, extras, p0, last_q, state
    return launches


def hadi_oracle(edges, n_vertices, b0):
    """HADI's float64 global OR iteration of ``b0`` [n, trials, bits] with
    the sim loop's plateau stop: ``(b, curve, eff, hops_run)``.  Each hop
    is one scipy CSR product of the whole graph, clamped to 1."""
    import scipy.sparse as sp
    from repro_torch.graph.hadi import _effective_diameter, _fm_estimate
    adj = sp.csr_matrix((np.ones(len(edges)), (edges[:, 1], edges[:, 0])),
                        shape=(n_vertices, n_vertices))
    b = b0.reshape(n_vertices, -1)
    curve = [_fm_estimate(b0)]
    for _ in range(HADI_HOPS):
        b = np.maximum(b, np.minimum(adj @ b, 1.0))
        curve.append(_fm_estimate(b.reshape(b0.shape)))
        if curve[-1] <= curve[-2] * 1.0001:
            break
    eff, curve = _effective_diameter(curve)
    return b.reshape(b0.shape), curve, eff, len(curve) - 1


def phase_hadi(torch, edges, parts, n_vertices):
    """HADI through the device entry point vs the float64 global OR
    oracle (bit for bit; one graph launch), then the engine's ms per hop
    and its graph replay against its eager loop."""
    from repro_torch.graph.engine import csr_matvec_wide
    from repro_torch.graph.hadi import hadi, make_hadi_engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    (eff, curve, stats), launches = main_path(lambda: hadi(
        edges, n_vertices, m=M, degrees=DEGREES, max_hops=HADI_HOPS,
        bits=HADI_BITS, trials=HADI_TRIALS, backend="device", device=DEVICE))
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want_b, want_curve, want_eff, want_hops = hadi_oracle(
        edges, n_vertices, stats["b0"])
    oracle_s = time.perf_counter() - t0
    assert np.array_equal(stats["b_final"], want_b), "bitstrings"
    assert np.array_equal(curve, want_curve), (curve, want_curve)
    assert (eff, stats["hops_run"]) == (want_eff, want_hops), \
        (eff, stats["hops_run"], want_eff, want_hops)
    assert stats["engine"]["dispatches"] == \
        stats["engine"]["graph_launches"] == 1, stats["engine"]
    hops = stats["hops_run"]
    req = [np.union1d(p.in_idx, p.out_idx).astype(np.uint32) for p in parts]
    engine, extras, state0 = make_hadi_engine(
        parts, req, DEGREES, HADI_BITS, HADI_TRIALS, stats["b0"],
        device=DEVICE)
    graph, _ = graph_check(torch, engine, hops, state0, extras, reps=3)
    hop_s = graph["round_wall_s"]
    rp, cols, wts = extras["row_ptr"], extras["cols"], extras["wts"]
    product_ms = cuda_ms(lambda: csr_matvec_wide(rp, cols, wts, state0),
                         reps=10)
    nnz, width = int(cols.numel()), int(state0.shape[-1])
    out_rows = int(rp.numel() - 1)
    state_bytes = int(state0.numel() * 4)
    emit({"phase": "hadi", "ok": True, "vertices": n_vertices,
          "edges": int(len(edges)), "nodes": M, "degrees": list(DEGREES),
          "max_hops": HADI_HOPS, "bits": HADI_BITS, "trials": HADI_TRIALS,
          "width": width, "hops_run": hops, "effective_diameter": eff,
          "curve": [float(c) for c in curve],
          "tolerance": "b_final, curve, eff, hops_run equal to the float64 "
                       "global OR iteration",
          "u_cap": engine.u_cap, "uin_cap": engine.uin_cap,
          "state_bytes": state_bytes,
          "trajectory_bytes": state_bytes * HADI_HOPS,
          "max_memory_allocated": int(peak),
          "max_memory_over_call": int(peak - base),
          "entry_point_s": total_s, "oracle_s": oracle_s,
          "hop_wall_s": hop_s, "graph": graph, "engine": stats["engine"],
          "wide_product": {
              "nnz": nnz, "width": width, "ms": product_ms,
              "bound_ms": bound_ms(nnz * 8 + rp.numel() * rp.element_size()
                                   + state0.numel() * 4
                                   + out_rows * width * 4),
              "bound_by": "bytes",
              "route": "plain torch ops (gather, index_add_)"},
          "launches": launches})
    del engine, extras, state0, stats
    torch.cuda.empty_cache()
    return launches


def phase_spectral(torch, edges, n_vertices):
    """Power iteration through the device entry point vs the float64
    reference (one graph launch), then the engine's ms per round and its
    graph replay against its eager loop."""
    from repro_torch.graph.engine import GraphEngine
    from repro_torch.graph.pagerank import build_partitions
    from repro_torch.graph.spectral import (make_spectral_engine,
                                            power_iteration,
                                            power_iteration_reference)
    t0 = time.perf_counter()
    lam_r, v_r = power_iteration_reference(edges, n_vertices,
                                           iters=SPECTRAL_ITERS)
    reference_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (lam, v, stats), launches = main_path(lambda: power_iteration(
        edges, n_vertices, m=M, degrees=DEGREES, iters=SPECTRAL_ITERS,
        backend="device", device=DEVICE))
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rel = abs(lam - lam_r) / lam_r
    cos = float(abs(v @ v_r) / (np.linalg.norm(v) * np.linalg.norm(v_r)))
    assert rel < 1e-4 and cos > 1 - 1e-6, (rel, cos)
    assert launches["spmv_csr"] == \
        SPECTRAL_ITERS + GraphEngine.WARMUP_ROUNDS, launches
    assert stats["engine"]["dispatches"] == \
        stats["engine"]["graph_launches"] == 1, stats["engine"]
    sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
    parts = build_partitions(sym, n_vertices, M)
    for p in parts:
        p.inv_outdeg = np.ones_like(p.inv_outdeg)
    engine, extras, state0 = make_spectral_engine(parts, n_vertices, DEGREES,
                                                  device=DEVICE)
    graph, _ = graph_check(torch, engine, SPECTRAL_ITERS, state0, extras)
    GRAPH_RAN["spectral"] = GraphEngine.WARMUP_ROUNDS + \
        stats["engine"]["graph_launches"] * graph["replay_spmv"]
    round_s = graph["round_wall_s"]
    emit({"phase": "spectral", "ok": True, "vertices": n_vertices,
          "nnz": int(extras["cols"].numel()), "nodes": M,
          "degrees": list(DEGREES), "iters": SPECTRAL_ITERS,
          "eigenvalue": lam, "reference_eigenvalue": lam_r,
          "eigenvalue_rel_err": rel, "cosine": cos,
          "tolerance": "eigenvalue rel err < 1e-4, cosine > 1 - 1e-6 vs "
                       "float64 power_iteration_reference",
          "u_cap": engine.u_cap, "uin_cap": engine.uin_cap,
          "max_memory_allocated": int(peak), "entry_point_s": total_s,
          "reference_s": reference_s, "round_wall_s": round_s,
          "graph": graph,
          "mesh_sums": engine.transport.sums, "engine": stats["engine"],
          "launches": launches})
    del engine, extras, state0
    return launches


def good_dead_sets(m_physical, count):
    """The first ``count`` steps of ``make_schedule("random", m_physical,
    8, seed=0)`` that lose no replica group."""
    from repro_torch.core.faults import make_schedule
    from repro_torch.core.replication import lost_logical_shards
    sched = make_schedule("random", m_physical, 8, seed=0)
    out = [d for d in sched.steps(64)
           if not lost_logical_shards(m_physical, REPLICATION, d)]
    assert len(out) >= count, out
    return out[:count]


def phase_replicated_planned(torch, parts):
    """Replicated planned reduce with a dead set vs the unreplicated
    reduce and the sim backend, bit for bit; repair; a lost group."""
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.replication import DeadLogicalNode, replica_groups
    out_sets = [p.out_idx.astype(np.uint32) for p in parts]
    in_sets = [p.in_idx.astype(np.uint32) for p in parts]
    rng = np.random.RandomState(7)
    values = [(rng.randint(-8, 9, len(o)) / 1024).astype(np.float32)
              for o in out_sets]
    d1, d2 = good_dead_sets(REPLICATION * M, 2)
    base = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE)
    base.config(out_sets, in_sets)
    want = base.reduce(values)
    ar = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE,
                         replication=REPLICATION, dead=d1)
    t0 = time.perf_counter()
    _, config_launches = main_path(lambda: ar.config(out_sets, in_sets))
    config_s = time.perf_counter() - t0
    config_cache = ar.config_cache
    got, launches = main_path(lambda: ar.reduce(values))
    launches = {k: v + config_launches[k] for k, v in launches.items()}
    sim = SparseAllreduce(M, DEGREES, backend="sim", replication=REPLICATION,
                          dead=d1)
    sim.config(out_sets, in_sets)
    for g, w, s in zip(got, want, sim.reduce(values)):
        assert np.array_equal(g, w), "replicated != unreplicated"
        assert np.array_equal(g, np.asarray(s, np.float32)), "!= sim"
    t0 = time.perf_counter()
    ar.reconfig_dead(d2)
    repair_s = time.perf_counter() - t0
    assert ar.config_cache == "repair", ar.config_cache
    for g, w in zip(ar.reduce(values), want):
        assert np.array_equal(g, w), "repaired != unreplicated"
    lost = set(replica_groups(REPLICATION * M, REPLICATION)[5])
    try:
        ar.reconfig_dead(lost)
        raise AssertionError("a lost replica group was accepted")
    except DeadLogicalNode:
        assert ar.dead == d2
    for g, w in zip(ar.reduce(values), want):
        assert np.array_equal(g, w), "after the refused repair"
    planned, _ = ar.planned_parts()
    staged = torch.zeros((REPLICATION * M, planned.u_cap), device=DEVICE)
    reduce_ms = cuda_ms(lambda: ar.reduce_fn(staged), reps=10)
    staged1 = torch.zeros((M, base.planned_parts()[0].u_cap), device=DEVICE)
    base_ms = cuda_ms(lambda: base.reduce_fn(staged1), reps=10)
    emit({"phase": "replicated_planned", "ok": True, "logical_nodes": M,
          "physical_nodes": REPLICATION * M, "replication": REPLICATION,
          "degrees": list(DEGREES), "dead": sorted(d1),
          "dead_repaired": sorted(d2), "lost_group_raised": sorted(lost),
          "max_abs_err": 0.0,
          "tolerance": "bit for bit vs unreplicated and vs sim (dyadic)",
          "config_s": config_s, "config_cache_before_repair": config_cache,
          "repair_s": repair_s,
          "u_cap": planned.u_cap, "uin_cap": planned.uin_cap,
          "depth": planned.depth, "reduce_ms": reduce_ms,
          "unreplicated_reduce_ms": base_ms, "launches": launches})
    return launches


def phase_replicated_union(torch):
    """Replicated union reduce with a dead set vs the unreplicated
    32-node reduce of each merge."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.sparse_vec import SENTINEL
    nodes = REP_UNION_NODES
    idx, val, want_idx, want_val = union_wire_inputs(nodes)
    n = len(want_idx)
    out_cap = shape_bucket(n)
    (dead,) = good_dead_sets(REPLICATION * nodes, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ti = torch.as_tensor(idx, device=DEVICE)
    tv = torch.as_tensor(val, device=DEVICE)
    want_i = torch.as_tensor(want_idx, device=DEVICE).expand(nodes, n)
    want_v = torch.as_tensor(want_val.astype(np.float32),
                             device=DEVICE).expand(nodes, n)
    amax = float(np.abs(want_val).max())
    pairs, total = [], {}
    for merge, wire in [(m, "raw") for m in MERGES] + [("banded",
                                                        "delta+int8ef")]:
        kw = dict(merge=merge, wire=wire, device=DEVICE, backend="device")
        ar = SparseAllreduce(nodes, REP_UNION_DEGREES, replication=REPLICATION,
                             dead=dead, **kw)
        (oi, ov, of), launches = main_path(
            lambda: ar.union_reduce(ti, tv, out_cap))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        assert int(of.sum()) == 0, (merge, wire, of.tolist())
        assert torch.equal(oi[:, :n], want_i), (merge, wire, "idx")
        assert bool((oi[:, n:] == SENTINEL).all()), (merge, wire)
        err = float((ov[:, :n] - want_v).abs().max())
        base = SparseAllreduce(nodes, REP_UNION_DEGREES, **kw)
        bi, bv, _ = base.union_reduce(ti, tv, out_cap)
        assert torch.equal(oi, bi), (merge, wire, "idx vs unreplicated")
        if wire == "raw":
            assert torch.equal(ov, bv), (merge, "values vs unreplicated")
            assert err == 0.0, (merge, err)
        else:
            assert err <= 0.05 * amax, (merge, wire, err, amax)
        del oi, ov, of, bi, bv
        ms = cuda_ms(lambda: ar.union_reduce(ti, tv, out_cap), reps=3,
                     warmup=1)
        base_ms = cuda_ms(lambda: base.union_reduce(ti, tv, out_cap), reps=3,
                          warmup=1)
        pairs.append({"merge": merge, "wire": wire, "ms": ms,
                      "unreplicated_ms": base_ms, "max_abs_err": err,
                      "launches": {k: v for k, v in launches.items() if v}})
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "replicated_union", "ok": True, "logical_nodes": nodes,
          "physical_nodes": REPLICATION * nodes, "replication": REPLICATION,
          "degrees": list(REP_UNION_DEGREES), "dead": sorted(dead),
          "union_count": n, "out_capacity": out_cap, "in_capacity": WIRE_C,
          "max_abs_union": amax, "max_memory_allocated": int(peak),
          "pairs": pairs,
          "tolerance": "idx exact; raw values bit for bit vs the "
                       "unreplicated reduce and the float64 oracle; "
                       "int8ef within 0.05 x max of exact"})
    del ti, tv, want_i, want_v
    return total


def fresh_plan_cache() -> str:
    """Point the plan cache at a new empty directory (under the run's
    scratch root) and drop the in-process memo, so each phase configures
    from nothing, as its numbers in PERF.md assume; returns the root."""
    import tempfile
    from repro_torch.core import autotune
    root = tempfile.mkdtemp(prefix="plans-", dir=SCRATCH["root"])
    os.environ[autotune.CACHE_ENV] = root
    autotune.clear_plan_memo()
    return root


# the run's scratch directory (plan caches, checkpoints), removed at exit
SCRATCH = {"root": None}


def pagerank_sets(parts):
    """PageRank's per-node out / in index sets."""
    return ([p.out_idx.astype(np.uint32) for p in parts],
            [p.in_idx.astype(np.uint32) for p in parts])


def plan_cache_probe(root: str, inputs: str, output: str) -> int:
    """``chip_smoke.py --plan-cache-probe ROOT IN OUT``: a restarted
    process configures PageRank's index sets from the plan cache at ROOT
    and writes its reduce of IN's values to OUT (the plan_cache phase)."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.autotune import PlanCache
    with np.load(inputs) as f:
        out_sets = [f[f"o{i}"] for i in range(M)]
        in_sets = [f[f"i{i}"] for i in range(M)]
        values = [f[f"v{i}"] for i in range(M)]
    ar = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE,
                         plan_cache=PlanCache(root=root))
    t0 = time.perf_counter()
    ar.config(out_sets, in_sets)
    torch.cuda.synchronize()
    config_s = time.perf_counter() - t0
    np.savez(output, *ar.reduce(values))
    emit({"config_cache": ar.config_cache, "config_s": config_s})
    return 0


def phase_plan_cache(torch, parts):
    """Config tiers on PageRank's index sets: fresh, memo, disk (memo
    cleared), disk again in a restarted process; the same reduce bits on
    normal floats from all four; ``degrees="auto"`` tuned, then cached."""
    from repro_torch.core import autotune
    from repro_torch.core.api import SparseAllreduce
    root = os.environ[autotune.CACHE_ENV]
    out_sets, in_sets = pagerank_sets(parts)
    rng = np.random.RandomState(21)
    values = [rng.randn(len(o)).astype(np.float32) for o in out_sets]
    tiers, results, total = {}, [], {}
    for want in ("fresh", "memo", "disk"):
        if want == "disk":
            autotune.clear_plan_memo()
        ar = SparseAllreduce(M, DEGREES, backend="device", device=DEVICE)
        t0 = time.perf_counter()
        _, launches = main_path(lambda: ar.config(out_sets, in_sets))
        torch.cuda.synchronize()
        tiers[want] = time.perf_counter() - t0
        assert ar.config_cache == want, (want, ar.config_cache)
        got, more = main_path(lambda: ar.reduce(values))
        for k in launches:
            total[k] = total.get(k, 0) + launches[k] + more[k]
        results.append(got)
        if want == "fresh":
            first = ar
        elif want == "memo":
            assert ar.reduce_fn is first.reduce_fn
    inputs = os.path.join(root, "probe_in.npz")
    output = os.path.join(root, "probe_out.npz")
    np.savez(inputs, **{f"o{i}": o for i, o in enumerate(out_sets)},
             **{f"i{i}": x for i, x in enumerate(in_sets)},
             **{f"v{i}": v for i, v in enumerate(values)})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--plan-cache-probe", root, inputs, output],
                          capture_output=True, text=True, timeout=300,
                          check=True)
    restart_s = time.perf_counter() - t0
    probe = json.loads(proc.stdout.strip().splitlines()[-1])
    assert probe["config_cache"] == "disk", probe
    with np.load(output) as f:
        results.append([f[f"arr_{i}"] for i in range(M)])
    for other in results[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(results[0], other)), \
            "config tiers reduce to different bits"
    n0 = float(np.mean([len(o) for o in out_sets]))
    sources = [SparseAllreduce(M, "auto", backend="device", device=DEVICE,
                               expected_nnz=n0, index_range=N_VERTICES
                               ).degrees_source for _ in range(2)]
    assert sources == ["tuned", "cache"], sources
    emit({"phase": "plan_cache", "ok": True, "nodes": M,
          "degrees": list(DEGREES),
          "config_s": {"fresh": tiers["fresh"], "memo": tiers["memo"],
                       "disk": tiers["disk"],
                       "disk_restarted_process": probe["config_s"]},
          "restarted_process_s": restart_s,
          "auto_degrees_sources": sources,
          "tolerance": "reduce bits of normal floats equal across fresh, "
                       "memo, disk and disk in a restarted process",
          "launches": total})
    return total


def phase_calibrate(torch, parts):
    """Fabric fit over the stacked transport, timed-trial plan selection
    (fused merge) and resolve_degrees under the fit.  The trials are
    timing tools, not main-path calls: their launches are reported here
    and counted nowhere else."""
    import functools
    from repro_torch.core import autotune
    from repro_torch.core.topology import ButterflyPlan
    from repro_torch.kernels import _build
    out_sets, _ = pagerank_sets(parts)
    n0 = float(np.mean([len(o) for o in out_sets]))
    t0 = time.perf_counter()
    fabric = autotune.calibrate_fabric(M, device=DEVICE, store=True)
    calibrate_s = time.perf_counter() - t0
    backend = autotune.backend_name(DEVICE)
    meta, _ = autotune.default_cache().load(autotune.fabric_cache_key(
        backend=backend, num_devices=M))
    assert autotune.calibrated_fabric(backend=backend,
                                      num_devices=M) == fabric
    _build.reset_launches()
    t0 = time.perf_counter()
    report = autotune.select_plan(
        M, n0, N_VERTICES, fabric, top_k=5,
        confirm=functools.partial(autotune.measure_plan, device=DEVICE,
                                  merge="fused"))
    select_s = time.perf_counter() - t0
    trial_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    _build.reset_launches()
    degrees, source = autotune.resolve_degrees(M, n0=n0,
                                               total_range=N_VERTICES,
                                               fabric=fabric)
    assert source == "tuned" and math.prod(degrees) == M
    emit({"phase": "calibrate", "ok": True, "nodes": M,
          "stage_degrees": list(autotune.stage_degrees(M)),
          "payload_entries": [256, 4096, 32768],
          "alpha_s": fabric.alpha_s, "beta_bytes_per_s":
          fabric.beta_bytes_per_s, "gamma_s": fabric.gamma_s,
          "fit_residual": meta["fit_residual"], "calibrate_s": calibrate_s,
          "select": {"n0": n0, "total_range": N_VERTICES, "merge": "fused",
                     "candidates": [
                         {"degrees": list(d), "modeled_ms": t * 1e3,
                          "measured_ms": report.measured_s[
                              str(ButterflyPlan(M, d))] * 1e3}
                         for t, d in report.candidates],
                     "winner": list(report.plan.degrees),
                     "decreasing": report.decreasing, "seconds": select_s},
          "resolved_degrees": list(degrees), "resolved_source": source,
          "trial_launches": trial_launches, "launches": {}})
    return {}


def phase_resilient_planned(torch, parts):
    """``ResilientAllreduce(64, (16, 4), replication=2)`` on PageRank's
    index sets (dyadic values): a replica-absorbed dead set repaired in
    place, a lost group shrunk to 63 survivors equal to a fresh reduce
    over them, the shrink reused, and a deeper loss raising
    ``QuorumLost``; then, with ``degrees="auto"``, the same loss shrunk
    with degrees from ``resolve_degrees(shrunk_from=64)`` on the base's
    plan cache (which then serves them), equal to the same reduce."""
    from repro_torch.core import autotune
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.replication import replica_groups
    from repro_torch.core.topology import tune
    from repro_torch.resilience import (DegradedPolicy, QuorumLost,
                                        ResilientAllreduce)
    out_sets, in_sets = pagerank_sets(parts)
    n0 = float(np.mean([len(o) for o in out_sets]))
    rng = np.random.RandomState(8)
    values = [(rng.randint(-8, 9, len(o)) / 1024).astype(np.float32)
              for o in out_sets]
    groups = replica_groups(REPLICATION * M, REPLICATION)
    (absorbed,) = good_dead_sets(REPLICATION * M, 1)
    lost = set(groups[5])
    deep = set().union(*groups[:M // 2 + 1])
    deads = [None, absorbed, lost, lost, deep]
    ra = ResilientAllreduce(M, DEGREES, replication=REPLICATION,
                            probe=lambda step, attempt: deads[step],
                            policy=DegradedPolicy(max_retries=0),
                            device=DEVICE, expected_nnz=n0,
                            index_range=N_VERTICES)
    total, ms = {}, {}

    def step(i, sup=ra):
        t0 = time.perf_counter()
        out, launches = main_path(lambda: sup.reduce(values, step=i))
        ms[i] = (time.perf_counter() - t0) * 1e3
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out

    t0 = time.perf_counter()
    main_path(lambda: ra.config(out_sets, in_sets))
    config_s = time.perf_counter() - t0
    base = step(0)
    assert not base.degraded
    rep = step(1)
    assert rep.event.klass == "replica-absorbed" and not rep.degraded
    assert ra.base.config_cache == "repair"
    assert all(np.array_equal(rep.values[i], base.values[i])
               for i in range(M)), "repair changed bits"
    shrink = step(2)
    sh = shrink.shrink
    surv = shrink.event.survivors
    assert shrink.degraded and len(surv) == M - 1 and 5 not in surv
    want_degrees = autotune.resolve_degrees(
        M - 1, n0=n0, total_range=N_VERTICES, replication=REPLICATION,
        shrunk_from=M, cache=autotune.PlanCache(
            os.path.join(os.environ[autotune.CACHE_ENV], "resolve")))[0]
    assert sh["degrees"] == want_degrees == tune(
        M - 1, n0=n0, total_range=N_VERTICES).degrees, sh
    assert sh["replication"] == REPLICATION
    fresh = SparseAllreduce(M - 1, sh["degrees"], backend="device",
                            replication=REPLICATION, device=DEVICE)
    fresh.config([out_sets[i] for i in surv], [in_sets[i] for i in surv])
    want = fresh.reduce([values[i] for i in surv])
    assert all(np.array_equal(shrink.values[sid], want[k])
               for k, sid in enumerate(surv)), "shrink != fresh survivors"
    again = step(3)
    assert ra.stats["shrinks"] == 1 and ra.stats["shrink_reuses"] == 1
    assert all(np.array_equal(again.values[s], shrink.values[s])
               for s in surv)
    try:
        step(4)
        raise AssertionError("a loss below quorum was accepted")
    except QuorumLost:
        pass
    auto = ResilientAllreduce(M, "auto", replication=REPLICATION,
                              probe=lambda step, attempt: lost
                              if step == 6 else None,
                              policy=DegradedPolicy(max_retries=0),
                              device=DEVICE, expected_nnz=n0,
                              index_range=N_VERTICES)
    main_path(lambda: auto.config(out_sets, in_sets))
    assert not step(5, auto).degraded
    auto_shrink = step(6, auto)
    ash = auto_shrink.shrink
    assert ash["degrees_source"] == "tuned", ash
    assert autotune.resolve_degrees(
        M - 1, n0=n0, total_range=N_VERTICES, replication=REPLICATION,
        shrunk_from=M, cache=auto.base.plan_cache) == \
        (ash["degrees"], "cache"), "auto shrink did not store its degrees"
    assert all(np.array_equal(auto_shrink.values[sid], want[k])
               for k, sid in enumerate(surv)), "auto shrink != survivors"
    emit({"phase": "resilient_planned", "ok": True, "logical_nodes": M,
          "replication": REPLICATION, "degrees": list(DEGREES),
          "absorbed_dead": sorted(absorbed), "lost_group": sorted(lost),
          "survivors": len(surv), "shrink_degrees": list(sh["degrees"]),
          "shrink_degrees_source": sh["degrees_source"],
          "shrink_config_cache": sh["config_cache"],
          "quorum_lost_dead": len(deep), "config_s": config_s,
          "reduce_ms": ms[0], "repair_ms": ms[1], "first_shrink_ms": ms[2],
          "reused_shrink_ms": ms[3], "stats": ra.stats,
          "auto_degrees": list(auto.base.plan.degrees),
          "auto_shrink_degrees": list(ash["degrees"]),
          "auto_shrink_degrees_source": ash["degrees_source"],
          "auto_shrink_ms": ms[6],
          "tolerance": "bit for bit: repair vs fault-free, shrink and "
                       "auto shrink vs a fresh reduce over the survivors "
                       "(dyadic)",
          "launches": total})
    return total


def survivor_oracle(idx, val, rows):
    """float64 union (indices, sums) of the chunks of ``rows``."""
    from repro_torch.core.sparse_vec import SENTINEL
    sel = idx[rows]
    keep = sel != SENTINEL
    u, inv = np.unique(sel[keep], return_inverse=True)
    return u, np.bincount(inv, weights=val[rows][keep].astype(np.float64))


def phase_resilient_union(torch):
    """``ResilientAllreduce`` on replicated_union's input (32 logical
    nodes, (8, 4), r = 2) with both replicas of one shard dead: 31
    survivors at r = 2 over one flat layer of 31 runs, fused and banded,
    equal to a fresh reduce over the survivors and the float64 oracle."""
    from repro_torch.core.allreduce import shape_bucket
    from repro_torch.core.api import SparseAllreduce
    from repro_torch.core.sparse_vec import SENTINEL
    from repro_torch.core.topology import tune
    from repro_torch.resilience import DegradedPolicy, ResilientAllreduce
    nodes, lost = REP_UNION_NODES, 5
    idx, val, _, _ = union_wire_inputs(nodes)
    surv = [i for i in range(nodes) if i != lost]
    want_idx, want_val = survivor_oracle(idx, val, surv)
    n = len(want_idx)
    out_cap = shape_bucket(n)
    ti = torch.as_tensor(idx, device=DEVICE)
    tv = torch.as_tensor(val, device=DEVICE)
    want_i = torch.as_tensor(want_idx, device=DEVICE)
    want_v = torch.as_tensor(want_val.astype(np.float32), device=DEVICE)
    pairs, total = [], {}
    for merge in ("fused", "banded"):
        ra = ResilientAllreduce(
            nodes, REP_UNION_DEGREES, replication=REPLICATION,
            probe=lambda step, attempt: {lost, lost + nodes},
            policy=DegradedPolicy(max_retries=0), merge=merge,
            device=DEVICE, index_range=WIRE_RANGE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, launches = main_path(lambda: ra.union_reduce(ti, tv, out_cap))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        assert res.degraded and res.event.survivors == tuple(surv)
        # 31 survivors: prime, so tune falls back to one flat layer
        assert res.shrink["degrees"] == tune(
            nodes - 1, n0=ra.expected_nnz, total_range=WIRE_RANGE).degrees \
            and res.shrink["replication"] == REPLICATION, res.shrink
        fresh = SparseAllreduce(nodes - 1, res.shrink["degrees"],
                                backend="device",
                                replication=REPLICATION, merge=merge,
                                device=DEVICE)
        fi, fv, fo = fresh.union_reduce(ti[surv], tv[surv], out_cap)
        for k, sid in enumerate(surv):
            gi, gv, go = res.values[sid]
            assert torch.equal(gi, fi[k]) and torch.equal(gv, fv[k]), \
                (merge, sid, "vs fresh")
            assert int(go) == int(fo[k]) == 0, (merge, sid, int(go))
            assert torch.equal(gi[:n], want_i) and \
                bool((gi[n:] == SENTINEL).all()), (merge, sid, "idx")
            assert torch.equal(gv[:n], want_v), (merge, sid, "vs oracle")
        del fi, fv, fo, res
        ms = cuda_ms(lambda: ra.union_reduce(ti, tv, out_cap), reps=3,
                     warmup=1)
        assert ra.stats["shrinks"] == 1 and ra.stats["shrink_reuses"] >= 1
        degrees = ra.last_shrink["degrees"]
        pairs.append({"merge": merge, "first_call_ms": first_ms,
                      "reused_shrink_ms": ms, "max_memory_allocated":
                      int(peak), "launches": {k: v for k, v in
                                              launches.items() if v}})
    emit({"phase": "resilient_union", "ok": True, "logical_nodes": nodes,
          "replication": REPLICATION, "degrees": list(REP_UNION_DEGREES),
          "lost_shard": lost, "survivors": len(surv),
          "survivor_degrees": list(degrees), "union_count": n,
          "out_capacity": out_cap, "pairs": pairs,
          "tolerance": "bit for bit vs a fresh reduce over the survivors "
                       "and the float64 oracle (dyadic)",
          "launches": total})
    del ti, tv, want_i, want_v
    return total


def soak_seed() -> int:
    """The first seed whose rack schedule over the POOL positions kills an
    engine position (one of the first M) at a round where the loop
    consults it (block starts from FAULT_AT on)."""
    from repro_torch.core.faults import make_schedule
    checked = [r for r in range(0, ROUNDS, CKPT_EVERY) if r >= FAULT_AT]
    for seed in range(100):
        sched = make_schedule("rack", POOL, RACK, seed=seed, rack_size=RACK)
        if any(min(sched.dead_at(r)) < M for r in checked):
            return seed
    raise AssertionError("no seed hits an engine position")


def phase_supervised_pagerank(torch, parts):
    """``SupervisedEngineLoop`` (M = 64 over a pool of 80, 10 rounds,
    checkpoints every 2) with a rack schedule from round 3: final state
    and last_q equal the fault-free run bit for bit, with a remap; every
    block one graph launch, and the fault-free run's replays equal one
    eager loop of the ten rounds."""
    from repro_torch.core.faults import make_schedule
    from repro_torch.graph.engine import GraphEngine
    from repro_torch.graph.pagerank import make_pagerank_app, pagerank_state
    from repro_torch.resilience import SupervisedEngineLoop
    seed = soak_seed()
    app, out_sets, in_sets = make_pagerank_app(parts, N_VERTICES, DAMPING)
    runs, total = {}, {}
    for name in ("clean", "rack"):
        sched = None if name == "clean" else make_schedule(
            "rack", POOL, RACK, seed=seed, rack_size=RACK)
        ckpt = os.path.join(SCRATCH["root"], f"supervised-{name}")
        loop = SupervisedEngineLoop(out_sets, in_sets, app, degrees=DEGREES,
                                    schedule=sched, fault_at=FAULT_AT,
                                    ckpt_dir=ckpt, ckpt_every=CKPT_EVERY,
                                    pool=POOL, device=DEVICE)
        remaps, engines = [], [loop.engine]
        supervise = loop._supervise

        def timed(rnd, loop=loop, supervise=supervise, remaps=remaps,
                  engines=engines):
            before = loop.remaps
            t0 = time.perf_counter()
            supervise(rnd)
            if loop.remaps != before:
                remaps.append({"round": rnd,
                               "seconds": time.perf_counter() - t0,
                               "config_cache": loop.engine.config_cache,
                               "nodes_first": loop.engine.nodes[0]})
            if loop.engine is not engines[-1]:
                engines.append(loop.engine)
        loop._supervise = timed
        extras, p0 = pagerank_state(parts, N_VERTICES, loop.engine.u_cap,
                                    loop.engine.uin_cap, device=DEVICE)
        t0 = time.perf_counter()
        (state, last_q), launches = main_path(
            lambda: loop.run(ROUNDS, p0, extras))
        torch.cuda.synchronize()
        runs[name] = {"state": state, "last_q": last_q, "remaps": remaps,
                      "seconds": time.perf_counter() - t0,
                      "events": [e.klass for e in loop.events],
                      "engine": loop.engine.sync_report()}
        rep = runs[name]["engine"]
        assert rep["graph_launches"] == rep["dispatches"] > 0, rep
        # the wrapper: each capture's warm-up round and the CKPT_EVERY
        # rounds it enqueues; the device: the warm-up rounds and every
        # replay's kernels, those of a traced replay of the block
        captures = sum(e.report["captures"] for e in engines)
        assert launches["spmv_csr"] == captures * (
            GraphEngine.WARMUP_ROUNDS + CKPT_EVERY), (launches, captures)
        replays = sum(e.report["graph_launches"] for e in engines)
        assert replays == ROUNDS // CKPT_EVERY, replays
        if name == "clean":
            # the blocks' replays against one eager loop of all rounds
            e_state, e_q, _ = loop.engine.eager_fn(ROUNDS)(p0, extras)
            assert torch.equal(e_state, state) and torch.equal(e_q, last_q), \
                "supervised replays differ from the eager loop"
            del e_state, e_q
            replay = replay_kernels(torch, loop.engine, CKPT_EVERY, p0,
                                    extras)
        runs[name]["spmv_ran"] = captures * GraphEngine.WARMUP_ROUNDS \
            + replays * replay["replay_spmv"]
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del extras, p0
    GRAPH_RAN[PHASE["name"]] = sum(r["spmv_ran"] for r in runs.values())
    clean, rack = runs["clean"], runs["rack"]
    assert len(rack["remaps"]) >= 1, rack["events"]
    assert torch.equal(clean["state"], rack["state"]) and \
        torch.equal(clean["last_q"], rack["last_q"]), "remapped run differs"
    emit({"phase": "supervised_pagerank", "ok": True,
          "vertices": N_VERTICES, "nodes": M, "pool": POOL,
          "degrees": list(DEGREES), "rounds": ROUNDS,
          "ckpt_every": CKPT_EVERY, "schedule": {
              "kind": "rack", "num_failures": RACK, "rack_size": RACK,
              "seed": seed, "fault_at": FAULT_AT},
          "events": rack["events"], "remaps": rack["remaps"],
          "clean_run_s": clean["seconds"], "rack_run_s": rack["seconds"],
          "engines": {"clean": clean["engine"], "rack": rack["engine"]},
          "graph_launches_per_run": 1, "graph_vs_eager_bit_identical": True,
          "block_replay": replay,
          "spmv_ran": {"clean": clean["spmv_ran"], "rack": rack["spmv_ran"]},
          "tolerance": "final state and last_q bit for bit vs the "
                       "fault-free run, and the fault-free run's block "
                       "replays vs one eager loop of all rounds",
          "launches": total})
    del runs
    return total


def phase_soak_resume(torch):
    """``python -m repro_torch.launch.soak --job pagerank`` at the smoke's
    graph size in subprocesses: a fault-free baseline, a rack-fault run
    killed at round 4 (exit 17), and its ``--resume``; final.npz equal to
    the baseline's array by array; the baseline's state and last_q equal
    to one eager loop of the same job in this process (:func:`soak_eager`)
    and each of its runs one graph launch.  The kernels run in the
    subprocesses, so their launches (as each run prints them) are
    reported here and kept apart from the in-process main-path counts."""
    seed = soak_seed()
    base_args = ["--job", "pagerank", "--vertices", str(N_VERTICES),
                 "--edges", str(N_EDGES), "--graph-nodes", str(M),
                 "--pool", str(POOL), "--steps", str(ROUNDS),
                 "--ckpt-every", str(CKPT_EVERY), "--seed", str(seed),
                 "--device", DEVICE]
    rack = ["--faults", "rack", "--fault-at", str(FAULT_AT),
            "--num-failures", str(RACK), "--rack-size", str(RACK)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}

    def soak(name, out, extra, rc):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.soak", "--out", out,
                               *base_args, *extra], env=env, cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == rc, (name, proc.returncode,
                                       proc.stdout[-2000:],
                                       proc.stderr[-4000:])
        tagged = lambda tag: [json.loads(line.split(" ", 1)[1]) for line in
                              proc.stdout.splitlines()
                              if line.startswith(tag + " ")]
        launches, engine = tagged("SOAK_LAUNCHES"), tagged("SOAK_ENGINE")
        runs[name] = {"seconds": time.perf_counter() - t0, "rc": rc,
                      "launches": {k: v for k, v in launches[0].items() if v}
                      if launches else None,
                      "engine": engine[0] if engine else None}
        return proc.stdout

    base = os.path.join(SCRATCH["root"], "soak-base")
    faulted = os.path.join(SCRATCH["root"], "soak-faulted")
    soak("baseline", base, [], 0)
    out = soak("killed", faulted, rack + ["--kill-at", "4"], 17)
    assert "KILL round 4" in out, out
    out = soak("resumed", faulted, rack + ["--resume"], 0)
    assert "resumed at round 4" in out, out
    with np.load(os.path.join(base, "final.npz")) as a, \
            np.load(os.path.join(faulted, "final.npz")) as b:
        assert sorted(a.files) == ["last_q", "scores", "state"]
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
        eager = soak_eager(torch, seed)
        for k, v in eager.items():
            assert np.array_equal(a[k], v), ("soak vs eager loop", k)
    eng = runs["baseline"]["engine"]
    assert eng["graph_launches"] == eng["dispatches"] \
        == ROUNDS // CKPT_EVERY, eng
    with open(os.path.join(faulted, "final.meta.json")) as f:
        meta = json.load(f)
    emit({"phase": "soak_resume", "ok": True, "seed": seed,
          "args": base_args + rack, "runs": runs,
          "remaps": meta["remaps"], "events": meta["events"],
          "graph_launches_per_run": 1, "graph_vs_eager_bit_identical": True,
          "tolerance": "final.npz (state, last_q, scores) equal array by "
                       "array to the fault-free baseline; the baseline's "
                       "state and last_q equal to one eager loop of the "
                       "soak's PageRank in this process",
          "launches": {}})
    return {}


def soak_eager(torch, seed):
    """The soak's PageRank job (its graph, partitions, degrees and seed)
    as one eager loop of ROUNDS rounds in this process: ``{"state",
    "last_q"}`` on the host."""
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.graph.engine import GraphEngine
    from repro_torch.graph.pagerank import (build_partitions,
                                            make_pagerank_app, pagerank_state)
    edges = powerlaw_graph(N_VERTICES, N_EDGES, seed=seed)
    parts = build_partitions(edges, N_VERTICES, M, seed=seed)
    app, out_sets, in_sets = make_pagerank_app(parts, N_VERTICES, DAMPING)
    engine = GraphEngine(out_sets, in_sets, app, degrees=(M,), seed=seed,
                         device=DEVICE)
    extras, p0 = pagerank_state(parts, N_VERTICES, engine.u_cap,
                                engine.uin_cap, device=DEVICE)
    state, last_q, _ = engine.eager_fn(ROUNDS)(p0, extras)
    return {"state": state.cpu().numpy(), "last_q": last_q.cpu().numpy()}


def train_close(torch, got, want, what):
    """allclose at rtol 1e-5 and atol 1e-7 x the larger max|value|."""
    atol = 1e-7 * max(float(want.abs().max()), float(got.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol, msg=what)


def host_leaves(tree):
    """The leaves of a tensor tree as CPU copies, in sorted-path order."""
    from repro_torch.models import transformer as T
    return [(path, t.cpu()) for path, t in T.tree_leaves(tree)]


def train_configs(torch, cfg, m, degrees, configs, steps=TRAIN_STEPS, tp=1):
    """``make_train_step`` of ``cfg`` over ``m`` stacked data positions,
    each with ``tp`` model positions (degrees ``degrees`` of the data
    axis, the launcher's batch 8 x seq 256, random weights from seed 0
    drawn afresh on the card for each configuration and donated to the
    step), ``steps`` steps of each (sync, merge, wire) in
    ``configs`` and then of fused / raw again, each a main-path call.  Per
    configuration: step ms (median of the steps after the first) with the
    forward +
    backward, sync and update ms by CUDA events, tokens/s, peak memory,
    losses, overflow.  Asserts: losses finite, the first within 1.5 of
    ln(vocab); overflow 0; ``delta`` = ``raw`` bit for bit (fused); the
    step-1 float32 embedding sync equal across the merges and to
    ``hier``'s (rtol 1e-5, atol 1e-7 x max), every other synced leaf
    bit-identical across the sparse raw configurations (held on the
    host); the repeat bit-identical (losses and final parameters, held on
    the host).  Returns ``(rows, launches, info)``."""
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step, mesh_ctx
    mc = mesh_ctx(m, tp, device=DEVICE)
    stream = batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [next(stream) for _ in range(steps)]
    opt = AdamW()
    hint = max(8, TRAIN_BATCH * TRAIN_SEQ // m)
    ln_v = math.log(cfg.vocab)
    info = {"sparse_in_capacity": hint, "ln_vocab": ln_v, "init_s": [],
            "steps": steps,
            "memory_allocated_before": torch.cuda.memory_allocated()}
    total, rows, keep, seen = {}, [], {}, set()

    def run(sync, merge, wire):
        step, _ = make_train_step(
            cfg, mc, sync=sync, opt=opt, dp_degrees={"data": degrees},
            sparse_tokens_hint=hint, sync_merge=merge, sync_wire=wire)
        # each configuration starts from an empty allocator cache: the
        # larger models' steps fail on blocks their predecessors split
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = T.init_params(cfg, tp, seed=0, device=DEVICE)
        torch.cuda.synchronize()
        info["init_s"].append(time.perf_counter() - t0)
        info["params"] = sum(t.numel() for _, t in T.tree_leaves(params))
        st = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"losses": [], "overflow": [], "step_ms": [], "fwd_bwd_ms": [],
               "sync_ms": [], "update_ms": []}
        for i, batch in enumerate(batches):
            ev = {s: torch.cuda.Event(enable_timing=True)
                  for s in ("start", "fwd_bwd", "sync", "update")}
            capture = {} if i == 0 else None
            ev["start"].record()
            params, st, mets = step(params, st, batch,
                                    mark=lambda s: ev[s].record(),
                                    capture=capture)
            torch.cuda.synchronize()
            out["losses"].append(float(mets["loss"]))
            out["overflow"].append(int(mets["sync_overflow"]))
            out["step_ms"].append(ev["start"].elapsed_time(ev["update"]))
            out["fwd_bwd_ms"].append(ev["start"].elapsed_time(ev["fwd_bwd"]))
            out["sync_ms"].append(ev["fwd_bwd"].elapsed_time(ev["sync"]))
            out["update_ms"].append(ev["sync"].elapsed_time(ev["update"]))
            if capture is not None:
                out["emb"] = capture["emb"]["f32"]
                if sync == "sparse" and wire == "raw":
                    out["synced"] = host_leaves(capture["synced"])
                del capture
        out["peak"] = torch.cuda.max_memory_allocated()
        if sync == "sparse":
            note_merge_steps(merge, wire, len(batches))
        if (sync, merge) == REPEAT[:2] and wire in ("raw", "delta"):
            out["params"] = host_leaves(params)
        return out

    for sync, merge, wire in configs + (REPEAT,):
        name = f"{sync}/{merge}/{wire}" if sync == "sparse" else sync
        repeat = name in seen
        res, launches = main_path(lambda: run(sync, merge, wire))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        losses = res["losses"]
        assert all(math.isfinite(x) for x in losses), (name, losses)
        assert abs(losses[0] - ln_v) < 1.5, (name, losses[0], ln_v)
        assert res["overflow"] == [0] * steps, (name, res["overflow"])
        med = lambda xs: float(np.median(xs[1:]))
        step_ms = med(res["step_ms"])
        rows.append({
            "config": name + (" (repeat)" if repeat else ""),
            "step_ms": step_ms, "fwd_bwd_ms": med(res["fwd_bwd_ms"]),
            "sync_ms": med(res["sync_ms"]), "update_ms": med(res["update_ms"]),
            "step_ms_all": res["step_ms"],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            "max_memory_allocated": int(res["peak"]), "losses": losses,
            "sync_overflow": res["overflow"],
            "launches": {k: v for k, v in launches.items() if v}})
        if sync == "hier":
            keep["hier_emb"] = res["emb"]
        elif "sparse_synced" not in keep:
            keep["sparse_synced"] = res["synced"]
            keep["sparse_emb"] = res["emb"]
            train_close(torch, res["emb"], keep["hier_emb"],
                        "sparse embedding rows vs hier")
        elif wire == "raw":
            train_close(torch, res["emb"], keep["sparse_emb"],
                        f"{name} embedding sync vs the first sparse one")
            for (path, a), (_, b) in zip(res["synced"], keep["sparse_synced"]):
                if path != ("emb",):
                    assert torch.equal(a, b), (name, path)
        if name == "sparse/fused/raw" and not repeat:
            keep[name] = (losses, res["params"])
        elif name in ("sparse/fused/delta", "sparse/fused/raw"):
            want_l, want_p = keep["sparse/fused/raw"]
            what = "repeat" if repeat else "delta vs raw"
            assert losses == want_l, (what, losses, want_l)
            assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
                res["params"], want_p)), what
        seen.add(name)
        del res
    del keep
    torch.cuda.empty_cache()
    info["init_s"] = info["init_s"][0]
    return rows, total, info


TRAIN_TOLERANCE = ("losses finite, step-1 loss within 1.5 of ln(vocab); "
                   "overflow 0; delta = raw bit for bit; step-1 f32 "
                   "embedding sync across merges and vs hier rtol 1e-5 + "
                   "1e-7 x max, other synced leaves bit-identical; repeat "
                   "bit-identical")


def cut_depth(cfg, layers):
    """``(cfg at `layers` layers, the phase line's `reduced` list)``."""
    if layers == cfg.n_layers:
        return cfg, []
    return (dataclasses.replace(cfg, n_layers=layers),
            [f"layers {cfg.n_layers} -> {layers}"])


def train_line(phase, cfg, m, degrees, rows, info, total, **extra):
    """The phase line of a train configuration set."""
    return {"phase": phase, "ok": True, "arch": cfg.name,
            "params": info["params"], "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "dtype": str(cfg.dtype), "data_positions": m,
            "degrees": list(degrees), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": info["steps"],
            "sparse_in_capacity": info["sparse_in_capacity"],
            "init_s": info["init_s"], "ln_vocab": info["ln_vocab"],
            "memory_allocated_before": info["memory_allocated_before"],
            **extra,
            "configs": rows, "tolerance": TRAIN_TOLERANCE, "launches": total}


def phase_train(torch):
    """The training stack at full width: qwen1.5-0.5b (untied: the sparse
    embedding leaf exists) over M = 8 stacked data positions, degrees (4,
    2), batch 8 x seq 256 (256 tokens a position: sparse capacities in
    256, out 2,048): ``hier``, then ``sparse`` with sort / fused / banded
    (raw), fused with ``delta`` and ``delta+int8ef``, banded with
    ``delta+int8ef``; then fused / raw again (:func:`train_configs`)."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH, "untied")
    rows, total, info = train_configs(torch, cfg, TRAIN_M, TRAIN_DEGREES,
                                      TRAIN_CONFIGS)
    emit(train_line("train", cfg, TRAIN_M, TRAIN_DEGREES, rows, info, total))
    return total


def tp_pair(torch, cfg, m, tp, degrees):
    """``cfg`` at (m, 1) and (m, tp) from the same seed-0 weights (asserted
    equal: the shapes coincide), one ``hier`` step each on the first
    batch: the step-1 losses, the synced gradients and the parameters
    before and after the step (host copies), held leaf by leaf to
    :data:`TP_PAIR_LIMITS` (the update only where the tp = 1 gradient
    exceeds its own bound, so the gradient bound fixes the sign AdamW's
    first step takes; leaves named in :data:`TP_PAIR_ZERO_GRAD` left
    out).  Returns the readings: per check the largest :func:`excess`
    (at most 1 holds) and its leaf."""
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step, mesh_ctx
    batch = next(batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    runs = {}
    for t in (1, tp):
        step, _ = make_train_step(cfg, mesh_ctx(m, t, device=DEVICE),
                                  sync="hier", opt=AdamW(),
                                  dp_degrees={"data": degrees})
        torch.cuda.empty_cache()
        params = T.init_params(cfg, t, seed=0, device=DEVICE)
        before = host_leaves(params)
        st = AdamW().init(params)
        capture = {}
        params, st, mets = step(params, st, batch, capture=capture)
        runs[t] = {"loss": float(mets["loss"]), "before": before,
                   "synced": host_leaves(capture["synced"]),
                   "after": host_leaves(params)}
        del params, st, capture, step
    torch.cuda.empty_cache()
    a, b = runs[tp], runs[1]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a["before"],
                                                          b["before"]))
    worst, left_out = tp_pair_excess(torch, a, b)
    ok = all(x <= 1.0 for x, _ in worst.values())
    out = {"data_positions": m, "tp": tp, "sync": "hier",
           "losses": {"tp1": b["loss"], f"tp{tp}": a["loss"]},
           "excess": {k: v[0] for k, v in worst.items()},
           "worst_leaf": {k: v[1] for k, v in worst.items()},
           "left_out": left_out, "limits": TP_PAIR_LIMITS, "ok": ok,
           "tolerance": "same seed-0 weights at tp 1 and tp; step-1 loss "
                        "|a - b| / |b|; each synced gradient leaf and each "
                        "leaf's update (after - before, on the elements "
                        "whose tp 1 gradient exceeds its bound) within "
                        "rtol + atol x the leaf's max |tp 1 value|; "
                        "excess: the largest |a - b| / bound (at most 1 "
                        "holds); left_out: leaves whose true gradient is 0"}
    assert ok, out
    return out


def tp_pair_excess(torch, a, b):
    """:func:`tp_pair`'s comparison of run ``a`` (tp > 1) with run ``b``
    (tp = 1), each ``{"loss", "before", "synced", "after"}`` with
    host leaves in the same order: ``({check: (excess, leaf)}, left
    out)``, the loss's excess against its relative limit, the leaves'
    by :func:`excess` against :data:`TP_PAIR_LIMITS`."""
    worst = {"loss": (abs(a["loss"] - b["loss"]) / abs(b["loss"])
                      / TP_PAIR_LIMITS["loss"], None),
             "grads": (0.0, None), "update": (0.0, None)}
    rtol, atol = TP_PAIR_LIMITS["grads"]
    left_out = []
    for (path, ga), (_, gb), (_, p0), (_, pa), (_, pb) in zip(
            a["synced"], b["synced"], b["before"], a["after"], b["after"]):
        name = "/".join(path)
        if path[-1] in TP_PAIR_ZERO_GRAD:
            left_out.append(name)
            continue
        gb64 = gb.double()
        checks = {"grads": excess(torch, ga, gb, TP_PAIR_LIMITS["grads"])}
        sure = gb64.abs() * (1 - rtol) > atol * float(gb64.abs().max())
        if bool(sure.any()):
            p0 = p0.double()
            checks["update"] = excess(torch, (pa.double() - p0)[sure],
                                      (pb.double() - p0)[sure],
                                      TP_PAIR_LIMITS["update"])
        for k, x in checks.items():
            if x >= worst[k][0]:
                worst[k] = (x, name)
    return worst, left_out


def train_run(torch, cfg, mc, degrees, sync, merge="sort", wire="raw",
              steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, **kw):
    """``steps`` steps of ``cfg`` on mesh ``mc`` (``make_train_step`` with
    ``degrees`` and the sync settings, ``kw`` passed on) from seed-0
    weights drawn on the card, on the launcher's batch stream: per step
    the step, forward + backward, sync and update ms (CUDA events),
    losses and overflow, and the caching allocator's device allocations,
    frees and retries and each stage's peak (``allocator``); the peak
    memory (the largest stage peak) and what was allocated before the
    run (``held``: earlier runs' results); row 0 of step 1's synced leaves
    and the parameters after the last step, on the card."""
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import make_train_step
    stream = batch_stream(cfg, batch, seq, seed=0)
    batches = [next(stream) for _ in range(steps)]
    step, _ = make_train_step(
        cfg, mc, sync=sync, opt=AdamW(), dp_degrees=degrees,
        sparse_tokens_hint=max(8, batch * seq // mc.dp), sync_merge=merge,
        sync_wire=wire, **kw)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    params = T.init_params(cfg, mc.tp, seed=0, device=DEVICE)
    st = AdamW().init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "overflow": [], "step_ms": [], "fwd_bwd_ms": [],
           "sync_ms": [], "update_ms": [], "allocator": [], "held": held}
    alloc_keys = {"cuda_mallocs": "segment.all.allocated",
                  "cuda_frees": "segment.all.freed",
                  "retries": "num_alloc_retries"}
    for i, b in enumerate(batches):
        before = torch.cuda.memory_stats()
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in ("start", "fwd_bwd", "sync", "update")}
        capture = {} if i == 0 else None
        peaks = {}

        def mark(k, ev=ev, peaks=peaks):
            ev[k].record()
            peaks[k] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        ev["start"].record()
        params, st, mets = step(params, st, b, mark=mark, capture=capture)
        torch.cuda.synchronize()
        out["losses"].append(float(mets["loss"]))
        out["overflow"].append(int(mets["sync_overflow"]))
        for k, a, z in (("step_ms", "start", "update"),
                        ("fwd_bwd_ms", "start", "fwd_bwd"),
                        ("sync_ms", "fwd_bwd", "sync"),
                        ("update_ms", "sync", "update")):
            out[k].append(ev[a].elapsed_time(ev[z]))
        after = torch.cuda.memory_stats()
        out["allocator"].append(
            {k: after.get(v, 0) - before.get(v, 0)
             for k, v in alloc_keys.items()}
            | {"reserved": after.get("reserved_bytes.all.current", 0),
               "peak_by_stage": peaks})
        if capture is not None:
            out["synced"] = [t for _, t in T.tree_leaves(capture["synced"])]
            del capture
    out["peak"] = max(max(a["peak_by_stage"].values())
                      for a in out["allocator"])
    out["params"] = [t for _, t in T.tree_leaves(params)]
    del params, st, step
    if sync == "sparse":
        note_merge_steps(merge, wire, len(batches))
    return out


def pair_diff(torch, a, b) -> dict:
    """Two :func:`train_run` results: the largest loss difference, and
    for the synced leaves and the final parameters the elements that
    differ and the largest |a - b| (all 0: bit for bit)."""
    out = {"loss": max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))}
    for key in ("synced", "params"):
        n, worst = 0, 0.0
        for x, y in zip(a[key], b[key]):
            k = int((x != y).sum())
            if k:
                n += k
                worst = max(worst, float((x.float() - y.float()).abs().max()))
        out[key] = {"differing": n, "max_abs_diff": worst}
    return out


def run_row(name, res, tokens):
    """A configuration's line entry from a :func:`train_run` result: the
    medians of the steps after the first."""
    med = lambda xs: float(np.median(xs[1:] if len(xs) > 1 else xs))
    step_ms = med(res["step_ms"])
    return {"config": name, "step_ms": step_ms,
            "fwd_bwd_ms": med(res["fwd_bwd_ms"]), "sync_ms": med(res["sync_ms"]),
            "update_ms": med(res["update_ms"]), "step_ms_all": res["step_ms"],
            "tokens_per_s": tokens / (step_ms / 1e3),
            "fwd_bwd_ms_all": res["fwd_bwd_ms"],
            "sync_ms_all": res["sync_ms"],
            "allocator_per_step": res["allocator"],
            "max_memory_allocated": int(res["peak"]),
            "memory_allocated_before": int(res["held"]),
            "losses": res["losses"], "sync_overflow": res["overflow"]}


def phase_train_pod(torch):
    """The ``pod`` axis on the card: qwen1.5-0.5b untied at full width on
    (pod, data, model) = (2, 2, 1), degrees {pod: (2,), data: (2,)}, against
    the flat (4, 1) mesh with {data: (2, 2)}, for ``hier``, sparse fused
    (raw) and sparse banded ``delta+int8ef``; then (2, 2, 2) against (4,
    2) (recorder phase ``train_pod_tp``) for ``hier`` and sparse fused;
    POD_STEPS steps each from the same seed-0 weights on the launcher's
    batch 8 x seq 256: losses, step 1's synced gradients and the
    parameters after, bit for bit (:func:`pair_diff` all 0); overflow 0,
    the first loss within 1.5 of ln(vocab)."""
    from repro_torch.configs import get_config
    from repro_torch.train.step import mesh_ctx
    cfg = get_config(TRAIN_ARCH, "untied")
    rows, total = [], {}
    pod_degrees = {"pod": (POD,), "data": (POD_DATA,)}
    flat_degrees = {"data": (POD, POD_DATA)}
    for label, tp, configs in (("train_pod", 1, POD_CONFIGS),
                               ("train_pod_tp", 2, POD_TP_CONFIGS)):
        PHASE["name"] = label
        for sync, merge, wire in configs:
            name = f"{sync}/{merge}/{wire}" if sync == "sparse" else sync
            res, entry = {}, {}
            for mesh in ("pod", "flat"):
                mc = mesh_ctx(POD_DATA, tp, pod=POD, device=DEVICE) \
                    if mesh == "pod" else mesh_ctx(POD * POD_DATA, tp,
                                                   device=DEVICE)
                degs = pod_degrees if mesh == "pod" else flat_degrees
                res[mesh], launches = main_path(lambda: train_run(
                    torch, cfg, mc, degs, sync, merge, wire, steps=POD_STEPS))
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                r = res[mesh]
                assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
                assert abs(r["losses"][0] - math.log(cfg.vocab)) < 1.5
                assert r["overflow"] == [0] * POD_STEPS, (name, r["overflow"])
                entry[mesh] = dict(
                    run_row(name, r, TRAIN_BATCH * TRAIN_SEQ),
                    mesh=mc.shape, degrees={a: list(d) for a, d
                                            in degs.items()},
                    launches={k: v for k, v in launches.items() if v})
            diff = pair_diff(torch, res["pod"], res["flat"])
            ok = diff["loss"] == 0 and all(
                diff[k]["differing"] == 0 for k in ("synced", "params"))
            rows.append({"config": name, "tp": tp, "pod": entry["pod"],
                         "flat": entry["flat"], "pair": diff,
                         "bit_for_bit": ok})
            assert ok, (name, tp, diff)
            del res
            torch.cuda.empty_cache()
    PHASE["name"] = "train_pod"
    emit({"phase": "train_pod", "ok": True, "arch": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "dtype": str(cfg.dtype),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": POD_STEPS,
          "configs": rows,
          "tolerance": "pod mesh vs its flat mesh with the degrees "
                       "concatenated, same weights and batches: losses, "
                       "step-1 synced gradients and final parameters bit "
                       "for bit; overflow 0; step-1 loss within 1.5 of "
                       "ln(vocab)",
          "launches": total})
    return total


def layer_check(torch, cfg, t):
    """qwen's layer-0 attention (seed-0 weights) on one row of ``t``
    normal bfloat16 activations on the card: ``attn_train_blocked``
    against ``attn_train``: bit for bit or not, the largest |a - b| over
    max |b|, and the ms of each (CUDA events)."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, 1, seed=0, device=DEVICE)
    p = {k: v[0] for k, v in params["blocks"]["b0"]["attn"].items()}
    del params
    x = torch.randn(1, t, cfg.d_model, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(3)
                    ).to(cfg.dtype)
    with torch.no_grad():
        want = A.attn_train(p, x, cfg, 1, cfg.window)
        got = A.attn_train_blocked(p, x, cfg, 1, cfg.window)
        out = {"seq": t, "bit_for_bit": bool(torch.equal(got, want)),
               "max_rel_diff": float((got.float() - want.float()).abs().max()
                                     / want.float().abs().max()),
               "blocked_ms": cuda_ms(lambda: A.attn_train_blocked(
                   p, x, cfg, 1, cfg.window), reps=5),
               "unblocked_ms": cuda_ms(lambda: A.attn_train(
                   p, x, cfg, 1, cfg.window), reps=5)}
    del p, x, got, want
    torch.cuda.empty_cache()
    assert out["max_rel_diff"] <= 2.0 ** -7, out
    return out


def phase_train_long(torch):
    """Sequences of 8,192 tokens: qwen1.5-0.5b untied at full width on
    LONG_M = 2 data positions, degrees (2,), batch 2 x seq 8,192 (one row
    a position: the block forward takes the query-chunked attention, and
    the sparse sync's capacities are 8,192 in, 16,384 out), ``hier`` and
    sparse fused, LONG_STEPS steps each: step ms, tokens/s, peak memory,
    losses finite and the first within 1.5 of ln(vocab), overflow 0.  Then
    the layer-0 attention on the card, blocked against unblocked, at T =
    2,048 and 8,192 (:func:`layer_check`, within 2^-7 of max)."""
    from repro_torch.configs import get_config
    from repro_torch.train.step import mesh_ctx
    cfg = get_config(TRAIN_ARCH, "untied")
    rows, total = [], {}
    mc = mesh_ctx(LONG_M, device=DEVICE)
    for sync, merge, wire in LONG_CONFIGS:
        name = f"{sync}/{merge}/{wire}" if sync == "sparse" else sync
        res, launches = main_path(lambda: train_run(
            torch, cfg, mc, {"data": (LONG_M,)}, sync, merge, wire,
            steps=LONG_STEPS, batch=LONG_BATCH, seq=LONG_SEQ))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
        assert abs(res["losses"][0] - math.log(cfg.vocab)) < 1.5
        assert res["overflow"] == [0] * LONG_STEPS, res["overflow"]
        rows.append(dict(run_row(name, res, LONG_BATCH * LONG_SEQ),
                         launches={k: v for k, v in launches.items() if v}))
        del res
        torch.cuda.empty_cache()
    checks = [layer_check(torch, cfg, t) for t in (2048, LONG_SEQ)]
    emit({"phase": "train_long", "ok": True, "arch": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "dtype": str(cfg.dtype),
          "data_positions": LONG_M, "degrees": [LONG_M],
          "batch": LONG_BATCH, "seq": LONG_SEQ, "steps": LONG_STEPS,
          "attention": "query-chunked (attn_train_blocked), Q_CHUNK 1,024; "
                       "per-block recompute only",
          "configs": rows, "layer_checks": checks,
          "tolerance": "losses finite, step-1 loss within 1.5 of ln(vocab); "
                       "overflow 0; blocked vs unblocked attention within "
                       "2^-7 x max",
          "launches": total})
    return total


def phase_train_overlap(torch):
    """The bucketed sync schedule on the card: qwen1.5-0.5b untied at full
    width over M = 8, degrees (4, 2), batch 8 x seq 256, ``hier`` with
    ``sync_overlap="bucketed"`` (the default 4 MB budget) against
    ``"off"``, OVERLAP_STEPS steps each from the same weights: losses,
    step 1's synced gradients and the final parameters bit for bit; sync
    ms of each; the buckets and the leaves they hold."""
    from repro_torch.configs import get_config
    from repro_torch.train import step as S
    cfg = get_config(TRAIN_ARCH, "untied")
    mc = S.mesh_ctx(TRAIN_M, device=DEVICE)
    res, rows, total = {}, [], {}
    for overlap in ("off", "bucketed"):
        res[overlap], launches = main_path(lambda: train_run(
            torch, cfg, mc, {"data": TRAIN_DEGREES}, "hier",
            steps=OVERLAP_STEPS, sync_overlap=overlap))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        r = res[overlap]
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        rows.append(dict(run_row(overlap, r, TRAIN_BATCH * TRAIN_SEQ),
                         sync_overlap=overlap))
    diff = pair_diff(torch, res["bucketed"], res["off"])
    ok = diff["loss"] == 0 and all(diff[k]["differing"] == 0
                                   for k in ("synced", "params"))
    sizes = [t.numel() + (-t.numel()) % TRAIN_M for t in res["off"]["params"]]
    buckets = S.plan_grad_buckets(sizes, S.DEFAULT_BUCKET_BYTES)
    del res
    torch.cuda.empty_cache()
    emit({"phase": "train_overlap", "ok": ok, "arch": cfg.name,
          "data_positions": TRAIN_M, "degrees": list(TRAIN_DEGREES),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": OVERLAP_STEPS,
          "bucket_bytes": S.DEFAULT_BUCKET_BYTES, "leaves": len(sizes),
          "buckets": len(buckets),
          "leaves_in_shared_buckets": sum(len(b) for b in buckets
                                          if len(b) > 1),
          "configs": rows, "pair": diff,
          "tolerance": "bucketed vs off, same weights and batches: losses, "
                       "step-1 synced gradients and final parameters bit "
                       "for bit",
          "launches": total})
    assert ok, diff
    return total


def moe_drops(torch, cfg, m, tp, batch):
    """Each MoE block's dropped fraction per (data, model) position on
    ``batch`` (a no-grad forward of the step's stacked layout from seed-0
    weights at tp), in block order."""
    from repro_torch.models import transformer as T
    from repro_torch.train.step import mesh_ctx
    params = T.init_params(cfg, tp, seed=0, device=DEVICE)
    tree = T.tree_from_leaves(params, [
        (p, t.unsqueeze(0).expand((m,) + tuple(t.shape)))
        for p, t in T.tree_leaves(params)])
    rows = lambda x: torch.as_tensor(np.asarray(x), device=DEVICE).long() \
        .reshape(m, -1, TRAIN_SEQ)
    seen, inner = [], T.MOE.moe_ffn

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out[2].cpu().tolist())
        return out
    T.MOE.moe_ffn = recording
    try:
        with torch.no_grad():
            T.forward_loss(tree, rows(batch["tokens"]), rows(batch["labels"]),
                           cfg, mesh_ctx(m, tp, device=DEVICE).axis_ctx(cfg))
    finally:
        T.MOE.moe_ffn = inner
    del params, tree
    torch.cuda.empty_cache()
    return seen


def phase_train_tp(torch):
    """The model axis on the card.  qwen1.5-0.5b untied at full width
    (vocab 151,936, the same padding at tp 1 and 2; 16 heads and kv 16,
    8 a position) on TP_M x TP_TP = 4 x 2 (data x model), degrees (2, 2)
    of the data axis, batch 8 x seq 256 (512 tokens a data position:
    sparse capacities in 512, out 2,048 over each vocab shard of 75,968
    rows): ``hier``, sparse sort / fused / banded (raw), fused and
    banded ``delta+int8ef`` (rows 1-6 all run), then fused / raw again,
    with :func:`train_configs`' asserts; the pair with the same weights at
    (4, 1) within :data:`TP_PAIR_LIMITS` (:func:`tp_pair`).  Then
    granite-moe-3b-a800m untied at full width (TP_MOE_LAYERS of its 32
    layers; vocab 49,155 padded to 49,184; 20 experts a position) on 2 x
    2, degrees (2,): ``hier``, sparse fused (raw) and its repeat, and
    each MoE block's dropped fraction per position on step 1's batch;
    and reduced granite (untied, TP_REPLAY) on 2 x 2: three ``hier`` steps
    on the card held to the CPU from the card's state before each step
    (:func:`hybrid_replay`: loss, every position's aux, synced gradients,
    gnorm, update within :data:`TP_REPLAY_LIMITS`).  The granite parts run
    as recorder phase ``train_tp_moe``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_stream
    cfg = get_config(TP_ARCH, "untied")
    torch.cuda.empty_cache()
    rows, total, info = train_configs(torch, cfg, TP_M, TP_DEGREES,
                                      TP_CONFIGS, tp=TP_TP)
    pair, launches = main_path(lambda: tp_pair(torch, cfg, TP_M, TP_TP,
                                               TP_DEGREES))
    assert not any(launches.values()), launches
    qwen = train_line("train_tp", cfg, TP_M, TP_DEGREES, rows, info, total,
                      tp=TP_TP, heads=cfg.n_heads, kv_heads=cfg.n_kv,
                      reduced=[], tp_pair=pair)
    PHASE["name"] = "train_tp_moe"
    mcfg, reduced = cut_depth(get_config(MOE_ARCH, "untied"), TP_MOE_LAYERS)
    torch.cuda.empty_cache()
    mrows, mtotal, minfo = train_configs(torch, mcfg, TP_MOE_M,
                                         TP_MOE_DEGREES, TP_MOE_CONFIGS,
                                         tp=TP_TP)
    drops = moe_drops(torch, mcfg, TP_MOE_M, TP_TP,
                      next(batch_stream(mcfg, TRAIN_BATCH, TRAIN_SEQ, 0)))
    (card, after), launches = main_path(lambda: hybrid_card(torch,
                                                            TP_REPLAY))
    assert not any(launches.values()), launches
    losses = [rec["loss"] for rec in card]
    assert all(math.isfinite(x) for x in losses), losses
    t0 = time.perf_counter()
    replay = hybrid_replay(torch, card, after, TP_REPLAY, TP_REPLAY_LIMITS)
    replay_s = time.perf_counter() - t0
    ok = all(x <= 1.0 for x in replay["excess"].values())
    rcfg = replay_cfg(TP_REPLAY)
    moe = train_line("train_tp_moe", mcfg, TP_MOE_M, TP_MOE_DEGREES, mrows,
                     minfo, mtotal, tp=TP_TP, n_experts=mcfg.n_experts,
                     top_k=mcfg.top_k, reduced=reduced,
                     dropped_per_position=drops,
                     dropped_max=max(max(r) for blk in drops for r in blk),
                     replay={"arch": rcfg.name, "reduced": ".reduced()",
                             "untied": True, "data_positions": TP_REPLAY["m"],
                             "tp": TP_REPLAY["tp"],
                             "degrees": list(TP_REPLAY["degrees"]),
                             "sync": "hier", "losses": losses,
                             "aux": [rec["aux_all"].tolist() for rec in card],
                             "gnorm": [rec["gnorm"] for rec in card],
                             "step_ms": [rec["ms"] for rec in card],
                             "cpu_replay_losses": replay["cpu_losses"],
                             "cpu_replay_s": replay_s,
                             "excess": replay["excess"],
                             "worst_at": replay["worst_at"],
                             "limits": TP_REPLAY_LIMITS})
    for k, v in mtotal.items():
        total[k] = total.get(k, 0) + v
    emit({"phase": "train_tp", "ok": ok, "qwen": qwen, "granite": moe,
          "launches": total})
    assert ok, replay
    return total


def moe_layer0(torch, cfg, m, batch):
    """The MoE's own numbers at layer 0 on ``batch`` (seed-0 weights,
    positions stacked): embed, block 0's attention, rmsnorm, ``moe_ffn``
    at the config's capacity -- dropped fraction and aux loss per
    position, the top-k copies each expert is sent (max, mean, min, the
    five largest), the copies beyond the expert capacity ``cap_e``, and
    the block's forward ms (CUDA events).  Also the ms of the copy
    ``torch.matmul`` makes of the three expert weights, broadcast over the
    positions (stride 0), to [M * E, ...] for its batched product, and
    that times two passes (the forward and the checkpoint's recompute) a
    layer, a step's worth."""
    from repro_torch.models import attention as A
    from repro_torch.models import common as C
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, 1, seed=0, device=DEVICE)
    b0 = {k: v for k, v in params["blocks"]["b0"].items()}
    b0 = T.tree_from_leaves(b0, [(p, t[0]) for p, t in T.tree_leaves(b0)])
    tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=DEVICE) \
        .long().reshape(m, -1, TRAIN_SEQ)
    with torch.no_grad():
        x = C.embed(params["emb"], tokens).to(cfg.dtype)
        h = C.rmsnorm(x, b0["ln1"], cfg.norm_eps)
        x = x + A.attn_train(b0["attn"], h, cfg, 1, cfg.window)
        h2 = C.rmsnorm(x, b0["ln2"], cfg.norm_eps)
        moe_p = {k: v.unsqueeze(0).expand((m,) + tuple(v.shape))
                 for k, v in b0["moe"].items()}
        fwd = lambda: MOE.moe_ffn(moe_p, h2, cfg, 1,
                                  capacity_factor=cfg.moe_capacity)
        _, aux, dropped = fwd()
        ms = cuda_ms(fwd, reps=5)
        copy_ms = cuda_ms(lambda: [
            moe_p[k].reshape((-1,) + tuple(moe_p[k].shape[2:]))
            for k in ("w1", "w3", "w2")], reps=5)
        n = h2[0].numel() // cfg.d_model
        _, _, ek = MOE.router_topk(C.linear(
            h2.reshape(m, n, -1).to(torch.float32), moe_p["router"]), cfg)
        load = torch.stack([torch.bincount(ek[i].reshape(-1),
                                           minlength=cfg.n_experts)
                            for i in range(m)]).cpu()
    cap_dev, cap_e = MOE.capacities(cfg, n, 1, cfg.moe_capacity)
    del params, b0, moe_p, x, h, h2
    return {"tokens_per_position": n, "cap_dev": cap_dev, "cap_e": cap_e,
            "dropped": dropped.cpu().tolist(), "aux": aux.cpu().tolist(),
            "load_max": load.max(1).values.tolist(),
            "load_mean": load.float().mean(1).tolist(),
            "load_min": load.min(1).values.tolist(),
            "load_top5": [sorted(r, reverse=True)[:5]
                          for r in load.tolist()],
            "copies_beyond_cap_e": torch.clamp(load - cap_e, min=0)
            .sum(1).tolist(), "moe_fwd_ms": ms,
            "expert_weight_copy_ms": copy_ms,
            "expert_weight_copy_ms_per_step": copy_ms * 2 * cfg.n_layers}


def phase_train_moe(torch):
    """granite-moe-3b-a800m untied at full width (MOE_LAYERS of its 32
    layers, d 1,536, 40 experts top-8 of d_ff 512, vocab 49,155 padded to
    49,168, bf16) over M = 2 stacked data positions, degrees (2,), batch
    8 x seq 256 (1,024 tokens a position: capacities cap_dev 16,384,
    cap_e 512; sparse capacities in 1,024, out 2,048): ``hier``, sparse
    sort / fused / banded (raw), fused ``delta+int8ef``, then fused / raw
    again, with :func:`train_configs`' asserts; the MoE's layer-0 numbers
    on step 1's batch (:func:`moe_layer0`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_stream
    cfg = get_config(MOE_ARCH, "untied")
    # the earlier phases' cached blocks go back first: train_moe peaks
    # near 68 GB, and a 7.5 GiB float32 sync copy failed on a cache
    # fragmented by small tensors in large segments
    torch.cuda.empty_cache()
    cfg, reduced = cut_depth(cfg, MOE_LAYERS)
    layer0 = moe_layer0(torch, cfg, MOE_M,
                        next(batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)))
    torch.cuda.empty_cache()
    rows, total, info = train_configs(torch, cfg, MOE_M, MOE_DEGREES,
                                      MOE_CONFIGS)
    emit(train_line("train_moe", cfg, MOE_M, MOE_DEGREES, rows, info, total,
                    n_experts=cfg.n_experts, top_k=cfg.top_k,
                    expert_d_ff=cfg.expert_d_ff, reduced=reduced,
                    moe_layer0=layer0))
    return total


def replay_cfg(spec):
    """The reduced config of a replay ``spec`` (HYBRID or TP_REPLAY)."""
    from repro_torch.configs import get_config
    return get_config(spec["arch"], spec.get("variant")).reduced()


def hybrid_setup(device, donate, spec=None):
    """The ``hier`` step of a replay ``spec`` (default HYBRID: reduced
    jamba over HYBRID_M stacked positions) on ``device``, its CPU-drawn
    seed-0 weights (the tree to rebuild states on) and the three batches:
    ``(step, like, batches)``."""
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_train_step, mesh_ctx
    spec = spec or HYBRID
    cfg = replay_cfg(spec)
    step, _ = make_train_step(
        cfg, mesh_ctx(spec["m"], spec["tp"], device=device), sync="hier",
        dp_degrees={"data": spec["degrees"]}, donate=donate)
    stream = batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    return (step, T.init_params(cfg, spec["tp"], seed=0, device="cpu"),
            [next(stream) for _ in range(TRAIN_STEPS)])


def hybrid_loss(torch, like, state, batch, spec=None):
    """The step's loss and aux metrics of a replay ``spec`` from a host
    state, a forward alone on the CPU (each data position's rows on its
    broadcast view of the parameters, as the step stacks them): the mean
    loss, the mean aux and the aux of every position ([M] or [M, tp])."""
    from repro_torch.models import transformer as T
    from repro_torch.train.step import mesh_ctx
    spec = spec or HYBRID
    cfg, m = replay_cfg(spec), spec["m"]
    tree = T.tree_from_leaves(like, [
        (p, state["params"][p].unsqueeze(0).expand(
            (m,) + tuple(state["params"][p].shape)))
        for p, _ in T.tree_leaves(like)])
    rows = lambda x: torch.as_tensor(np.asarray(x)).long().reshape(
        m, -1, TRAIN_SEQ)
    ax = mesh_ctx(m, spec["tp"], device="cpu").axis_ctx(cfg)
    with torch.no_grad():
        loss, aux = T.forward_loss(tree, rows(batch["tokens"]),
                                   rows(batch["labels"]), cfg, ax)
    return float(loss.mean()), float(aux.mean()), aux


def tree_on(like, flat, device):
    """A tree shaped as ``like`` of the tensors ``flat[path]`` on
    ``device``."""
    from repro_torch.models import transformer as T
    return T.tree_from_leaves(like, [(p, flat[p].to(device))
                                     for p, _ in T.tree_leaves(like)])


def host_state(params, st):
    """Parameters and AdamW state as host copies, keyed by path."""
    return {"params": dict(host_leaves(params)), "step": st.step.cpu(),
            "m": dict(host_leaves(st.m)), "v": dict(host_leaves(st.v))}


def state_on(like, state, device):
    """``(params, AdamWState)`` of a :func:`host_state` on ``device``."""
    from repro_torch.optim.adamw import AdamWState
    return (tree_on(like, state["params"], device),
            AdamWState(step=state["step"].to(device),
                       m=tree_on(like, state["m"], device),
                       v=tree_on(like, state["v"], device)))


def hybrid_card(torch, spec=None):
    """A replay ``spec``'s three ``hier`` steps on the card (default
    reduced jamba; no port kernel runs): per step the host state before
    it, the loss, aux (mean and every position's) and gradient norm, the
    synced gradients (host copies) and the host ms; and the host state
    after the last step."""
    from repro_torch.optim.adamw import AdamW
    step, like, batches = hybrid_setup(DEVICE, donate=True, spec=spec)
    params = tree_on(like, dict(host_leaves(like)), DEVICE)
    st = AdamW().init(params)
    out = []
    for batch in batches:
        rec = {"before": host_state(params, st)}
        capture = {}
        t0 = time.perf_counter()
        params, st, mets = step(params, st, batch, capture=capture)
        rec.update(loss=float(mets["loss"]), aux=float(mets["aux"]),
                   aux_all=capture["aux"].cpu(), gnorm=float(mets["gnorm"]),
                   ms=(time.perf_counter() - t0) * 1e3,
                   synced=dict(host_leaves(capture["synced"])))
        out.append(rec)
        del capture
    return out, host_state(params, st)


# the jamba replay's limits: (rtol, atol as a multiple of max|CPU value|).
# grads: tests/test_torch_ssm.py's bound for reduced jamba against the
# reference (its stack amplifies rounding in the backward); on an H100
# the card's step-1 gradients part from the CPU's by about 2e-4 x max
HYBRID_LIMITS = {"loss": (1e-4, 0.0), "aux": (1e-4, 0.0),
                 "gnorm": (1e-5, 0.0), "grads": (1e-4, 1e-3),
                 "update": (1e-6, 1e-6)}
HYBRID = {"arch": HYBRID_ARCH, "m": HYBRID_M, "tp": 1,
          "degrees": HYBRID_DEGREES}
# reduced granite's replay at (2, 2) (TP_REPLAY): HYBRID_LIMITS but for the
# gradients, which take the tp test's bound (rtol 1e-4 + 1e-5 x max):
# granite has no SSM, and its card step-1 gradients read 0.00072 of the
# jamba bound, about 0.07 of this one (this script on an NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md)
TP_REPLAY_LIMITS = dict(HYBRID_LIMITS, grads=(1e-4, 1e-5))


def excess(torch, got, want, limit):
    """max |got - want| / (rtol |want| + atol max|want|): at most 1 is
    within ``limit`` = (rtol, atol multiple)."""
    got, want = torch.as_tensor(got, dtype=torch.float64), \
        torch.as_tensor(want, dtype=torch.float64)
    rtol, atol = limit
    bound = rtol * want.abs() + atol * float(want.abs().max())
    diff = (got - want).abs()
    off = diff > 0
    return float((diff[off] / bound[off]).max()) if bool(off.any()) else 0.0


def hybrid_replay(torch, card, after, spec=None, limits=None):
    """The CPU witness of :func:`hybrid_card`, in this process after the
    card's steps, each step from the card's state before it.  Step 1 runs
    whole on the CPU: the card's loss, aux and synced gradients (leaf by
    leaf) against the CPU step's.  Steps 2 and 3: the card's loss and aux
    against a CPU forward (:func:`hybrid_loss`).  Every step: the card's
    gradient norm against the norm of its synced gradients on the CPU,
    and the card's state after the step (parameters and both moments)
    against AdamW on the CPU from the card's state before it and its
    synced gradients and norm (the update alone).  The aux check covers
    every position's aux too (each model position's at tp > 1).  Returns
    the readings: for each check the largest :func:`excess` over steps
    and leaves (at most 1 holds ``limits``, default :data:`HYBRID_LIMITS`),
    where it was, and the CPU losses."""
    from repro_torch.optim.adamw import AdamW
    lim = limits or HYBRID_LIMITS
    step, like, batches = hybrid_setup("cpu", donate=False, spec=spec)
    opt = AdamW()
    worst = {k: (0.0, None) for k in lim}

    def seen(check, x, where):
        if x > worst[check][0]:
            worst[check] = (x, where)
    cpu_losses = []
    nexts = [rec["before"] for rec in card[1:]] + [after]
    for i, (rec, batch, nxt) in enumerate(zip(card, batches, nexts)):
        params, st = state_on(like, rec["before"], "cpu")
        if i == 0:
            capture = {}
            _, _, mets = step(params, st, batch, capture=capture)
            loss, aux = float(mets["loss"]), float(mets["aux"])
            aux_all = capture["aux"]
            for path, g in host_leaves(capture["synced"]):
                seen("grads", excess(torch, rec["synced"][path], g,
                                     lim["grads"]), (i, path))
            del capture
        else:
            loss, aux, aux_all = hybrid_loss(torch, like, rec["before"],
                                             batch, spec)
        cpu_losses.append(loss)
        seen("loss", excess(torch, [rec["loss"]], [loss],
                            lim["loss"]), i)
        seen("aux", excess(torch, [rec["aux"]], [aux], lim["aux"]),
             i)
        seen("aux", excess(torch, rec["aux_all"], aux_all,
                           lim["aux"]), i)
        gnorm = math.sqrt(sum(float(torch.sum(torch.square(g.double())))
                              for g in rec["synced"].values()))
        seen("gnorm", excess(torch, [rec["gnorm"]], [gnorm],
                             lim["gnorm"]), i)
        grads = tree_on(like, rec["synced"], "cpu")
        new_p, new_st, _ = opt.update(grads, st, params,
                                      gnorm=torch.tensor(rec["gnorm"]))
        assert int(new_st.step) == int(nxt["step"]), (i, "step")
        for name, tree in (("params", new_p), ("m", new_st.m),
                           ("v", new_st.v)):
            for path, t in host_leaves(tree):
                seen("update", excess(torch, nxt[name][path], t,
                                      lim["update"]),
                     (i, name, path))
    return {"excess": {k: v[0] for k, v in worst.items()},
            "worst_at": {k: repr(v[1]) for k, v in worst.items()},
            "cpu_losses": cpu_losses}


def block_ms(torch, cfg, kind, m):
    """Forward ms (CUDA events) of one ``kind`` block (seed-0 weights of
    its first occurrence, position-stacked over ``m``) on an input of the
    train shape [m, 8 / m, 256, d]."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, 1, seed=0, device=DEVICE)
    blk = next(b for b in params["blocks"].values() if kind in b)
    p = {k: v[0].unsqueeze(0).expand((m,) + tuple(v.shape[1:]))
         for k, v in blk[kind].items()}
    del params, blk
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    x = torch.randn((m, TRAIN_BATCH // m, TRAIN_SEQ, cfg.d_model),
                    generator=gen, device=DEVICE).to(cfg.dtype)
    fn = {"mlstm": SSM.mlstm_train, "slstm": SSM.slstm_train}[kind]
    with torch.no_grad():
        return cuda_ms(lambda: fn(p, x, cfg), reps=3, warmup=1)


def phase_train_ssm(torch):
    """xlstm-1.3b untied at full width (SSM_LAYERS of its 48 layers, 7
    mLSTM + 1 sLSTM a period, d 2,048, 4 heads of 512, vocab 50,304,
    bf16) over M = 8
    stacked data positions, degrees (4, 2), batch 8 x seq 256, SSM_STEPS
    steps a configuration: ``hier``, sparse fused / banded (raw), fused
    and banded ``delta+int8ef``, then fused / raw again, with
    :func:`train_configs`' asserts, and the forward ms of one mLSTM and
    one sLSTM block; then reduced jamba (one period: 7 mamba + 1
    attention, dense and MoE FFNs alternating, d 256, float32) over M = 4,
    degrees (2, 2), ``hier``: three steps on the card
    (:func:`hybrid_card`), each held to the CPU from the card's state
    before it (:func:`hybrid_replay`), every check within
    :data:`HYBRID_LIMITS`."""
    from repro_torch.configs import get_config
    cfg, reduced = cut_depth(get_config(SSM_ARCH, "untied"), SSM_LAYERS)
    blocks = {k: block_ms(torch, cfg, k, SSM_M) for k in ("mlstm", "slstm")}
    torch.cuda.empty_cache()
    rows, total, info = train_configs(torch, cfg, SSM_M, SSM_DEGREES,
                                      SSM_CONFIGS, steps=SSM_STEPS)
    (card, after), launches = main_path(lambda: hybrid_card(torch))
    assert not any(launches.values()), launches
    losses = [rec["loss"] for rec in card]
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(512)) < 1.5, losses
    t0 = time.perf_counter()
    replay = hybrid_replay(torch, card, after)
    replay_s = time.perf_counter() - t0
    ok = all(x <= 1.0 for x in replay["excess"].values())
    hcfg = get_config(HYBRID_ARCH).reduced()
    emit(train_line("train_ssm", cfg, SSM_M, SSM_DEGREES, rows, info, total,
                    ok=ok, heads=cfg.n_heads, pattern=list(cfg.pattern),
                    reduced=reduced,
                    block_fwd_ms=blocks,
                    hybrid={"arch": hcfg.name, "reduced": ".reduced()",
                            "pattern": list(hcfg.pattern),
                            "ffn_pattern": list(hcfg.ffn_pattern),
                            "d_model": hcfg.d_model,
                            "dtype": str(hcfg.dtype),
                            "data_positions": HYBRID_M,
                            "degrees": list(HYBRID_DEGREES), "sync": "hier",
                            "losses": losses,
                            "aux": [rec["aux"] for rec in card],
                            "gnorm": [rec["gnorm"] for rec in card],
                            "step_ms": [rec["ms"] for rec in card],
                            "cpu_replay_losses": replay["cpu_losses"],
                            "cpu_replay_s": replay_s,
                            "excess": replay["excess"],
                            "worst_at": replay["worst_at"],
                            "limits": HYBRID_LIMITS,
                            "tolerance": "from the card's state before "
                                         "each step: loss and aux vs the "
                                         "CPU (step 1 a whole step, 2-3 a "
                                         "forward), step 1's synced "
                                         "gradients vs the CPU step's, "
                                         "gnorm vs the CPU norm of the "
                                         "card's gradients, AdamW's update "
                                         "vs the CPU's from the card's "
                                         "state and gradients; each within "
                                         "(rtol, atol x max|CPU|) of "
                                         "limits; excess <= 1 holds"}))
    assert ok, replay
    return total


def phase_train_encdec(torch):
    """whisper-base untied, nothing cut (6 encoder + 6 decoder layers, d
    512, 8 heads, d_ff 2,048, vocab 51,865 padded to 51,872, bf16) over M =
    8 stacked data positions, degrees (4, 2), the launcher's batch 8 x seq
    256 with 1,500 stub frames a row (sparse capacities in 256, out
    2,048): the train phase's configurations and asserts
    (:func:`train_configs`)."""
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH, "untied")
    torch.cuda.empty_cache()
    rows, total, info = train_configs(torch, cfg, ENCDEC_M, ENCDEC_DEGREES,
                                      TRAIN_CONFIGS)
    emit(train_line("train_encdec", cfg, ENCDEC_M, ENCDEC_DEGREES, rows,
                    info, total, enc_layers=cfg.enc_layers,
                    enc_frames=cfg.enc_seq, heads=cfg.n_heads,
                    d_ff=cfg.d_ff, reduced=[]))
    return total


def pair_error(a, b) -> dict:
    """``max |a - b| / max |b|`` and ``||a - b|| / ||b||`` in float32."""
    a, b = a.float(), b.float()
    d = a - b
    return {"max_rel": float(d.abs().max() / b.abs().max()),
            "l2_rel": float(d.norm() / b.norm())}


def fsdp_pair(torch, cfg):
    """``cfg`` at VLM_PAIR_LAYERS from the same seed-0 weights, ``hier``,
    TRAIN_STEPS steps with ``fsdp=True`` and then ``False``: losses, step
    and forward + backward ms, peaks; step 1's synced gradients compared
    (the FSDP leaves by :func:`pair_error` against FSDP_PAIR_LIMITS, every
    other leaf bit for bit).  Asserts the step-1 losses bit-equal and the
    limits."""
    from repro_torch.launch.train import batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.models.sharding import fsdp_block_paths
    from repro_torch.train.step import make_train_step, mesh_ctx
    mc = mesh_ctx(VLM_M, device=DEVICE)
    stream = batch_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    base = dataclasses.replace(cfg, n_layers=VLM_PAIR_LAYERS)
    fsdp_paths = fsdp_block_paths(dataclasses.replace(base, fsdp=True))
    runs, first = {}, None
    errors, fsdp_leaves = {}, 0
    for fsdp in (True, False):
        c = dataclasses.replace(base, fsdp=fsdp)
        step, _ = make_train_step(c, mc, sync="hier", opt=AdamW(),
                                  dp_degrees={"data": VLM_DEGREES})
        params = T.init_params(c, 1, seed=0, device=DEVICE)
        st = AdamW().init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"losses": [], "step_ms": [], "fwd_bwd_ms": []}
        for i, batch in enumerate(batches):
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ("start", "fwd_bwd", "sync", "update")}
            capture = {} if i == 0 else None
            ev["start"].record()
            params, st, mets = step(params, st, batch,
                                    mark=lambda k: ev[k].record(),
                                    capture=capture)
            torch.cuda.synchronize()
            out["losses"].append(float(mets["loss"]))
            out["step_ms"].append(ev["start"].elapsed_time(ev["update"]))
            out["fwd_bwd_ms"].append(ev["start"].elapsed_time(ev["fwd_bwd"]))
            if capture is None:
                continue
            synced = T.tree_leaves(capture["synced"])
            del capture
            if first is None:
                first = [(p, t.cpu()) for p, t in synced]
                continue
            for (path, a), (_, b) in zip(first, synced):
                if path[0] == "blocks" and path[1:] in fsdp_paths:
                    fsdp_leaves += 1
                    errors["/".join(path)] = pair_error(a.to(b.device), b)
                else:
                    assert torch.equal(a, b.cpu()), ("fsdp pair", path)
            del synced
        out["peak"] = torch.cuda.max_memory_allocated()
        runs["fsdp" if fsdp else "plain"] = out
        del params, st, step
        torch.cuda.empty_cache()
    del first
    a, b = runs["fsdp"], runs["plain"]
    assert a["losses"][0] == b["losses"][0], (a["losses"], b["losses"])
    worst = {k: max(e[k] for e in errors.values()) for k in FSDP_PAIR_LIMITS}
    assert fsdp_leaves == 7, fsdp_leaves     # wq, wk, wv, wo, w1, w2, w3
    assert all(worst[k] <= FSDP_PAIR_LIMITS[k] for k in worst), worst
    med = lambda xs: float(np.median(xs[1:]))
    return {"layers": VLM_PAIR_LAYERS, "sync": "hier",
            "losses": {k: r["losses"] for k, r in runs.items()},
            "step_ms": {k: med(r["step_ms"]) for k, r in runs.items()},
            "fwd_bwd_ms": {k: med(r["fwd_bwd_ms"]) for k, r in runs.items()},
            "max_memory_allocated": {k: int(r["peak"])
                                     for k, r in runs.items()},
            "peak_saved": int(b["peak"] - a["peak"]),
            "fsdp_leaves": fsdp_leaves, "grad_error_worst": worst,
            "grad_error": errors, "limits": FSDP_PAIR_LIMITS,
            "tolerance": "step-1 losses bit-equal; step 1's synced FSDP "
                         "leaves within limits (max |a - b| / max |b|, "
                         "||a - b|| / ||b||), every other synced leaf "
                         "bit-equal"}


def phase_train_vlm(torch):
    """internvl2-26b untied at full width with ``fsdp=True`` as published
    (d 6,144, 48 heads, kv 8, head_dim 128, d_ff 16,384, vocab 92,553
    padded to 92,560, bf16), VLM_LAYERS of its 48 layers, over M = 4
    stacked data positions, degrees (2, 2), batch 8 x seq 256 text after
    1,024 stub image tokens a row (T = 1,280; sparse capacities in 512,
    out 2,048): ``hier``, sparse fused / banded (raw), fused ``delta``,
    then fused / raw again, with :func:`train_configs`' asserts (no
    ``delta+int8ef``: its carry alone would be 4 x 92,560 x 6,144 float32,
    9.1 GB); then the FSDP pair (:func:`fsdp_pair`)."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH, "untied")
    assert cfg.fsdp
    torch.cuda.empty_cache()
    cfg, reduced = cut_depth(cfg, VLM_LAYERS)
    rows, total, info = train_configs(torch, cfg, VLM_M, VLM_DEGREES,
                                      VLM_CONFIGS)
    pair, launches = main_path(lambda: fsdp_pair(torch, cfg))
    assert not any(launches.values()), launches
    emit(train_line("train_vlm", cfg, VLM_M, VLM_DEGREES, rows, info, total,
                    fsdp=cfg.fsdp, img_tokens=cfg.img_tokens,
                    heads=cfg.n_heads, kv_heads=cfg.n_kv, d_ff=cfg.d_ff,
                    reduced=reduced,
                    no_int8ef="delta+int8ef left out: its error-feedback "
                              "carry alone would be 4 x 92,560 x 6,144 "
                              "float32, 9.1 GB", fsdp_pair=pair))
    return total


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def dtoh_check(torch, fn, expect: int, reps: int = 3, tries: int = 5):
    """Device-to-host copies of ``fn`` (one decode step and the host read
    of its ids) from ``torch.profiler`` traces of ``reps`` calls, read
    from the exported trace's memcpy records: the copies and bytes a
    call, asserted to be one copy of ``expect`` bytes; also the kernels
    a call launches and their summed device ms (the device's busy time,
    against the step's CUDA-event time).  A trace
    is taken again, up to ``tries`` times in all, unless it holds ``reps``
    kernel launches of the argmax (a trace whose device events are not
    whole)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = None
    for _ in range(tries):
        path = os.path.join(SCRATCH["root"], "dtoh_trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        PROFILER["traces"] += 1
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and "DtoH" in e.get("name", "")]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        argmax = [e for e in kernels if "argmax" in e.get("name", "").lower()]
        seen = {"copies": len(copies), "argmax_kernels": len(argmax),
                "bytes": [e.get("args", {}).get("bytes") for e in copies],
                "kernels": len(kernels),
                "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3}
        if len(argmax) == reps:
            break
    else:
        raise RuntimeError(f"profiler: no whole decode trace in {tries} "
                           f"tries; the last held {seen}")
    assert len(copies) == reps and all(b == expect for b in seen["bytes"]), \
        ("decode step copies to the host", seen, expect)
    return {"copies_per_step": len(copies) // reps, "bytes_per_step":
            sum(seen["bytes"]) // reps, "expected_bytes": expect,
            "kernels_per_step": seen["kernels"] / reps,
            "kernel_ms_per_step": seen["kernel_ms"] / reps}


def consistency_readings(torch, cfg, mc, params, s_b: int, extras=None,
                         against="prefill", dtype=None):
    """The decode of token S after a prefill of S tokens, M rows of Zipf
    prompts, on the real vocab, in the torch dtype ``dtype`` (None: the
    config's; else the config's leaves cast to it), against ``against``:
    ``"prefill"``, the prefill of S + 1 on the card; ``"cpu"``, the same
    prefill and decode of row 0 on a CPU copy of the weights (the path the
    CPU tests hold to the reference).  ``rel_err``: max |logit
    difference| / max |logit| of the reference logits; ``stale_rel_err``:
    the same of a decode from an empty cache (a decode that ignores its
    cache); each row's top-two margin of the reference over its max
    |logit| (``margins``) and whether the greedy ids agree
    (``ids_equal``); the max |softmax difference|, a printout only (at
    these vocab sizes no two softmaxes differ by much)."""
    from repro_torch.data.pipeline import zipf_tokens
    from repro_torch.models import transformer as T
    from repro_torch.train.step import (init_cache_global, make_decode_step,
                                        make_prefill_step, mesh_ctx)
    if dtype is not None:
        params = T.tree_from_leaves(params, [
            (k, t.to(getattr(torch, dtype)) if t.dtype == cfg.dtype else t)
            for k, t in T.tree_leaves(params)])
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    rng = np.random.RandomState(7)
    b = mc.dp
    toks = zipf_tokens(rng, (b, s_b + 1), cfg.vocab)
    max_seq = s_b + 2 + cfg.img_tokens
    pos = np.full(b, s_b + cfg.img_tokens)

    def decode_after_prefill(mesh, weights, rows):
        """The decode of token S after the prefill of S tokens of the
        first ``rows`` rows, the same decode from an empty cache, and the
        prefill of S + 1."""
        pre, _ = make_prefill_step(cfg, mesh, max_seq)
        dec, _ = make_decode_step(cfg, mesh)
        batch = {k: v[:rows] for k, v in (extras or {}).items()}
        batch["tokens"] = toks[:rows, :s_b]
        _, cache = pre(weights, batch)
        cross = ()
        if cfg.enc_layers:
            from repro_torch.launch.serve import _cross_cache
            cross = (_cross_cache(cfg, mesh, weights, batch["enc_frames"]),)
        args = (toks[:rows, s_b], pos[:rows])
        got, _ = dec(weights, *args, cache, *cross)
        del cache
        stale, _ = dec(weights, *args,
                       init_cache_global(cfg, mesh, rows, max_seq), *cross)
        if against == "cpu":
            return got, stale, None
        return got, stale, pre(weights, dict(batch, tokens=toks[:rows]))[0]

    got, stale, want = decode_after_prefill(mc, params, b)
    if against == "cpu":
        cpu = T.tree_from_leaves(params, [(k, t.cpu())
                                          for k, t in T.tree_leaves(params)])
        want = decode_after_prefill(mesh_ctx(1, mc.tp, device="cpu"), cpu,
                                    1)[0].to(got.device)
        got, stale = got[:1], stale[:1]
    got, stale, want = (t[:, :cfg.vocab].float() for t in (got, stale, want))
    scale = float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    return {"against": against, "dtype": str(cfg.dtype), "prompt": s_b,
            "rows": want.shape[0],
            "max_abs_logit": scale,
            "rel_err": float((got - want).abs().max()) / scale,
            "stale_rel_err": float((stale - want).abs().max()) / scale,
            "margins": ((top2[:, 0] - top2[:, 1]) / scale).tolist(),
            "ids_equal": (got.argmax(-1) == want.argmax(-1)).tolist(),
            "softmax_max_abs_diff": float(
                (torch.softmax(got, -1) - torch.softmax(want, -1))
                .abs().max())}


def serve_consistency(torch, cfg, mc, params, s_b: int, extras=None):
    """(b): :func:`consistency_readings` against ``SERVE_CONSISTENCY``'s
    reference for ``cfg``, held to ``SERVE_REL_BOUND``: ``rel_err`` <
    bound; the greedy ids equal on every row whose top-two margin clears
    the bound; and ``stale_rel_err`` > bound, so that a decode that
    ignored its cache would fail.  ``SERVE_PRINTOUTS``' readings are
    added under ``printouts``, unchecked."""
    against, dtype = SERVE_CONSISTENCY[cfg.name]
    tol = SERVE_REL_BOUND
    r = consistency_readings(torch, cfg, mc, params, s_b, extras, against,
                             dtype)
    assert r["rel_err"] < tol, ("decode vs reference", cfg.name, r, tol)
    assert r["stale_rel_err"] > tol, ("bound too loose", cfg.name, r, tol)
    decided = [m > tol for m in r["margins"]]
    assert all(eq for eq, d in zip(r["ids_equal"], decided) if d), \
        ("greedy ids vs reference", cfg.name, r, tol)
    printouts = [consistency_readings(torch, cfg, mc, params, s_b, extras,
                                      *spec)
                 for spec in SERVE_PRINTOUTS.get(cfg.name, ())]
    return dict(r, bound=tol, decided_rows=sum(decided), printouts=printouts)


def serve_phase(torch, phase, cfg, data, tp, n_req, slots, prompt, gen,
                dispatches, s_b):
    """``ContinuousBatchingScheduler`` of ``cfg`` (seed-0 weights on the
    card) on (data, model) = (``data``, ``tp``) with ``slots`` slots, a
    Zipf(1.2) stream of ``n_req`` requests of ``prompt`` tokens and
    ``max_new`` ``gen``: the sequential oracle first, then the batched
    service once for each (merge, wire) of ``dispatches`` (the sparse
    dispatch over the data positions; ``None``: no dispatch), each a
    main-path call: (a) its ids equal the oracle's token for token, (c)
    every id < vocab; then (b) :func:`serve_consistency` at ``s_b``
    prompt tokens and (d) :func:`dtoh_check` of one scheduler decode step
    (``slots`` x 4 bytes).  Prefill ms (one join's greedy prefill, CUDA
    events), decode ms a step (the scheduler's greedy decode step at its
    shapes), each run's tokens/s (host wall of the service run), plan hit
    rate and launches, peak memory."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   DecodeService, zipf_request_stream)
    from repro_torch.serve.dispatch import SparseServeDispatch
    from repro_torch.serve.service import run_sequential_oracle
    from repro_torch.train.step import mesh_ctx
    mc = mesh_ctx(data, tp, device=DEVICE)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, tp, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def stream():
        return zipf_request_stream(n_req, cfg.vocab, alpha=1.2,
                                   prompt_lens=(prompt,),
                                   max_new=(gen, gen), seed=0)
    sched = ContinuousBatchingScheduler(cfg, mc, params, slots=slots,
                                        max_seq=prompt + gen + 1)
    t0 = time.perf_counter()
    oracle = run_sequential_oracle(sched, stream())
    oracle_s = time.perf_counter() - t0
    runs, total, last = [], {}, None
    for spec in dispatches:
        disp = None
        reqs = stream()
        if spec is not None:
            disp = SparseServeDispatch(mc.dp, vocab=cfg.vocab,
                                       n_experts=cfg.n_experts,
                                       merge=spec[0], wire=spec[1],
                                       device=DEVICE, seed=1)
            disp.fit_hot_set(np.concatenate([r.prompt for r in reqs]),
                             head_size=64)
        sched.reset()
        sched.dispatch = disp
        report, launches = main_path(lambda: DecodeService(sched).run(reqs))
        done = {r.rid: list(r.tokens) for r in report.completed}
        assert len(done) == n_req, (phase, spec, len(done))
        for i, r in enumerate(reqs):
            assert done[r.rid] == oracle[i], (phase, spec, r.rid)
            assert all(0 <= t < cfg.vocab for t in done[r.rid]), r.rid
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if disp is not None:
            note_merge_steps(spec[0], spec[1], disp.steps)
        runs.append({"merge": spec and spec[0], "wire": spec and spec[1],
                     "steps": report.steps, "decode_steps":
                     sched.metrics.decode_steps,
                     "tokens_out": report.tokens_out, "wall_s": report.wall_s,
                     "tokens_per_s": report.tokens_per_s,
                     "plan_hit_rate": report.plan_hit_rate,
                     "dispatch_steps": disp.steps if disp else 0,
                     "launches": {k: v for k, v in launches.items() if v},
                     "oracle_equal": True})
        last = disp
    sched.dispatch = None
    toks = np.tile(np.asarray(stream()[0].prompt)[None], (mc.dp, 1))
    prefill_ms = cuda_ms(lambda: sched._prefill(params, {"tokens": toks}),
                         reps=3, warmup=1)
    decode_ms = cuda_ms(lambda: sched._decode(params, sched._tok, sched._pos,
                                              sched._cache), reps=20)
    dtoh = dtoh_check(torch, lambda: sched._decode(
        params, sched._tok, sched._pos, sched._cache)[0].cpu(), slots * 4)
    consistency = serve_consistency(torch, cfg, mc, params, s_b)
    out = {"phase": phase, "ok": True, "arch": cfg.name,
           "params": int(sum(t.numel() for _, t in T.tree_leaves(params))),
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "tied": cfg.tie_embeddings,
           "dtype": str(cfg.dtype), "data": data, "model": tp,
           "slots": slots, "requests": n_req, "prompt": prompt,
           "max_new": gen, "max_seq": prompt + gen + 1, "init_s": init_s,
           "oracle_s": oracle_s, "prefill_ms": prefill_ms,
           "decode_ms_per_step": decode_ms, "runs": runs,
           "consistency": consistency, "dtoh": dtoh,
           "peak_memory": torch.cuda.max_memory_allocated(),
           "memory_allocated_before": held,
           "checks": "(a) batched = sequential oracle token for token in "
                     "every run; (b) decode logits vs the arch's "
                     "reference within SERVE_REL_BOUND x max |logit|, "
                     "greedy ids equal where the margin clears it, an "
                     "empty-cache decode outside it; (c) ids < vocab; (d) "
                     "one DtoH copy of slots x 4 bytes a decode step",
           "launches": total}
    return out, params, mc, last, stream


def phase_serve(torch):
    """qwen1.5-0.5b as published (tied, 24 layers, d 1,024, vocab
    151,936, bf16) on SERVE_M = 4 data positions, slots 8: 16 Zipf(1.2)
    requests of 512 tokens, ``max_new`` 32 (max_seq 545), the oracle then
    the batched service with the sparse dispatch over the 4 positions for
    each (merge, wire) of SERVE_DISPATCH (the tail union through the
    merge-rank and scatter kernels); then the same stream at (data, model)
    = (2, 2) with the fused raw dispatch (recorder phase ``serve_tp``)
    (:func:`serve_phase`'s checks)."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH)
    assert cfg.tie_embeddings
    line, params, _, _, _ = serve_phase(
        torch, "serve", cfg, SERVE_M, 1, SERVE_REQUESTS, SERVE_SLOTS,
        SERVE_PROMPT, SERVE_GEN, SERVE_DISPATCH, SERVE_PROMPT)
    del params
    total = dict(line["launches"])
    PHASE["name"] = "serve_tp"
    tp_line, params, _, _, _ = serve_phase(
        torch, "serve_tp", cfg, SERVE_TP[0], SERVE_TP[1], SERVE_REQUESTS,
        SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN, (SERVE_TP_DISPATCH,),
        SERVE_PROMPT)
    PHASE["name"] = "serve"
    del params
    for k, v in tp_line.pop("launches").items():
        total[k] = total.get(k, 0) + v
    line["serve_tp"] = tp_line
    line["launches"] = total
    emit(line)
    return total


def phase_serve_moe(torch):
    """granite-moe-3b-a800m as published (tied, d 1,536, 40 experts
    top-8, vocab 49,155) but at SERVE_MOE["layers"] of its 32 layers at (data, model) = (2, 2), slots 4 (the
    decode drops nothing: ``moe_decode_drops_nothing``), 8 requests, the
    fused raw dispatch with the expert-load exchange: ``expert_load`` of
    the predictor's experts for each position's prompt tokens equals their
    bincount; (b) at SERVE_MOE_CONSISTENCY_PROMPT tokens, where the longer
    prefill drops nothing (:func:`serve_phase`'s checks)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.dispatch import (first_moe_router,
                                            make_expert_predictor)
    from repro_torch.serve.scheduler import moe_decode_drops_nothing
    s = SERVE_MOE
    cfg, reduced = cut_depth(get_config(s["arch"]), s["layers"])
    assert moe_decode_drops_nothing(cfg, s["slots"] // s["data"], s["tp"])
    # (b)'s longer prefill: one row of S + 1 tokens a data position
    assert moe_decode_drops_nothing(cfg, SERVE_MOE_CONSISTENCY_PROMPT + 1,
                                    s["tp"])
    line, params, mc, disp, stream = serve_phase(
        torch, "serve_moe", cfg, s["data"], s["tp"], s["requests"],
        s["slots"], s["prompt"], s["gen"], (("fused", "raw"),),
        SERVE_MOE_CONSISTENCY_PROMPT)
    pred = make_expert_predictor(cfg)
    router = first_moe_router(params)
    reqs = stream()
    eks = [pred(params["emb"], router, np.concatenate(
        [r.prompt for r in reqs[n::mc.dp]])) for n in range(mc.dp)]
    load = disp.expert_load(eks)
    want = sum(np.bincount(e.cpu().numpy().reshape(-1),
                           minlength=cfg.n_experts) for e in eks)
    assert np.array_equal(load, want.astype(np.float32)), (load, want)
    line["expert_load"] = {"equal_to_bincount": True,
                           "assignments": int(load.sum()),
                           "max": float(load.max()), "min": float(load.min())}
    line["reduced"] = reduced
    emit(line)
    return line["launches"]


def phase_serve_ssm(torch):
    """xlstm-1.3b as published (tied, 7 mLSTM + 1 sLSTM a period, d
    2,048, vocab 50,304, bf16) but at SERVE_SSM["layers"] of its 48 on 2 data positions, slots 4, 4
    requests of 256 tokens, ``max_new`` 16, no dispatch; (b) at 127 prompt
    tokens, in float32 against the same prefill and decode on a CPU copy
    (``SERVE_CONSISTENCY``) (:func:`serve_phase`'s checks)."""
    from repro_torch.configs import get_config
    s = SERVE_SSM
    cfg, reduced = cut_depth(get_config(s["arch"]), s["layers"])
    line, params, _, _, _ = serve_phase(
        torch, "serve_ssm", cfg, s["data"], s["tp"], s["requests"],
        s["slots"], s["prompt"], s["gen"], (None,), 127)
    del params
    line["reduced"] = reduced
    emit(line)
    return line["launches"]


def phase_serve_encdec(torch):
    """whisper-base as published (tied, 6 encoder + 6 decoder layers, d
    512, vocab 51,865, 1,500 stub frames a row, bf16), the launcher's
    fixed-batch path on 2 data positions: 4 rows of 64 prompt tokens, the
    cross cache built once (``build_cross_cache``), 16 greedy ids a row.
    (a) row independence in the batch's geometry: row 0's ids equal those
    of the same batch with every other row's prompt and frames replaced;
    (b) decode vs the longer prefill; (c) ids < vocab; (d) one DtoH copy
    of rows x 4 bytes a decode step.  Prefill ms, cross-cache ms, decode
    ms a step."""
    import argparse
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _cross_cache, _fixed_batch_generate
    from repro_torch.models import transformer as T
    from repro_torch.train.step import (make_decode_greedy_step,
                                        make_prefill_greedy_step, mesh_ctx)
    s = SERVE_ENCDEC
    cfg = get_config(s["arch"])
    mc = mesh_ctx(s["data"], device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, 1, seed=0, device=DEVICE)
    args = argparse.Namespace(prompt_len=s["prompt"], gen=s["gen"],
                              requests=s["rows"], seed=0)
    gen, launches = main_path(lambda: _fixed_batch_generate(cfg, mc, params,
                                                            args))
    assert gen.shape == (s["rows"], s["gen"]) and int(gen.max()) < cfg.vocab
    other = argparse.Namespace(**vars(args))
    other.seed = 1
    # row independence: the seed-0 batch's row 0 with seed-1 rows around it
    rng0, rng1 = np.random.RandomState(0), np.random.RandomState(1)
    b, p = s["rows"], s["prompt"]
    t0, t1 = (r.randint(0, cfg.vocab, (b, p)).astype(np.int32)
              for r in (rng0, rng1))
    f0, f1 = (r.randn(b, cfg.enc_seq, cfg.d_model).astype(np.float32)
              for r in (rng0, rng1))
    t1[0], f1[0] = t0[0], f0[0]
    max_seq = p + s["gen"]
    prefill, _ = make_prefill_greedy_step(cfg, mc, max_seq)
    decode, _ = make_decode_greedy_step(cfg, mc)

    def generate(toks, frames):
        tok, cache = prefill(params, {"tokens": toks, "enc_frames": frames})
        cross = _cross_cache(cfg, mc, params, frames)
        ids = [tok.cpu().numpy()]
        for i in range(s["gen"] - 1):
            tok, cache = decode(params, tok, np.full(b, p + i), cache, cross)
            ids.append(tok.cpu().numpy())
        return np.stack(ids, 1), (tok, cache, cross)
    mixed, _ = generate(t1, f1)
    assert np.array_equal(mixed[0], gen[0]), (mixed[0], gen[0])
    _, (tok, cache, cross) = generate(t0, f0)
    batch = {"tokens": t0, "enc_frames": f0}
    prefill_ms = cuda_ms(lambda: prefill(params, batch), reps=3, warmup=1)
    cross_ms = cuda_ms(lambda: _cross_cache(cfg, mc, params, f0), reps=3,
                       warmup=1)
    pos = np.full(b, p + s["gen"] - 1)
    decode_ms = cuda_ms(lambda: decode(params, tok, pos, cache, cross),
                        reps=20)
    dtoh = dtoh_check(torch, lambda: decode(params, tok, pos, cache,
                                            cross)[0].cpu(), b * 4)
    consistency = serve_consistency(torch, cfg, mc, params, p,
                                    extras={"enc_frames": f0[:mc.dp]})
    emit({"phase": "serve_encdec", "ok": True, "arch": cfg.name,
          "layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
          "enc_frames": cfg.enc_seq, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "dtype": str(cfg.dtype), "data": s["data"],
          "rows": b, "prompt": p, "gen": s["gen"], "prefill_ms": prefill_ms,
          "cross_cache_ms": cross_ms, "decode_ms_per_step": decode_ms,
          "tokens_per_s_device": b * 1e3 / decode_ms,
          "row_independent": True, "consistency": consistency,
          "dtoh": dtoh, "peak_memory": torch.cuda.max_memory_allocated(),
          "checks": "(a) row 0's ids unchanged with the other rows "
                    "replaced; (b) decode logits vs the longer prefill "
                    "within SERVE_REL_BOUND x max |logit|, greedy ids equal "
                    "where the margin clears it, an empty-cache decode "
                    "outside it; (c) ids < vocab; (d) one DtoH copy of "
                    "rows x 4 bytes a decode step", "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# The decode layouts: split-KV and 2D weight-stationary (serve2d)
# ---------------------------------------------------------------------------

def fill_cache(torch, cache, seed: int, fill) -> None:
    """Every cache leaf, one period at a time, set to a seeded float32
    normal draw on the card times ``fill`` = (k scale, v scale), cast to
    the leaf's dtype.  The reference's test fills 0.1 x both; against
    keys that small a query's scores are nearly equal, the attention
    averages the noise away and the cache moves the logits little, so a
    shard dropped or masked wrongly hardly shows (:func:`layout_pair`'s
    control reads how much it does; ``tools/splitkv_fill_probe.py``
    compares fills)."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for path, leaf in T.cache_leaves(cache):
        scale = fill[0] if path[-1] == "k" else fill[1]
        for i in range(leaf.shape[0]):
            leaf[i].copy_(torch.randn(leaf[i].shape, generator=gen,
                                      device=DEVICE) * scale)


def attn_leaves(cache):
    """The cache's leaves, every one an attention block's k or v
    [n_periods, B, S, KVg, hd] (so in every layout configuration)."""
    from repro_torch.models import transformer as T
    leaves = list(T.cache_leaves(cache))
    assert all(p[-1] in ("k", "v") for p, _ in leaves), [p for p, _ in
                                                         leaves]
    return [t for _, t in leaves]


def slots_at(torch, leaves, pos):
    """Every leaf's slot at ``pos`` [B] of each row, float32 [leaves,
    n_periods, B, KVg, hd]."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return torch.stack([t[:, rows, pos].float() for t in leaves])


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max()) / float(b.abs().max())


def routed(torch, fn, rows: int, on: bool):
    """``(fn(), routes)``: ``routes`` [MoE layers, rows, top_k] the sorted
    experts each row's token went to, recorded from
    ``models.moe.router_topk`` (both decode paths route through it) while
    ``fn`` runs; None unless ``on``."""
    if not on:
        return fn(), None
    from repro_torch.models import moe as MOE
    orig, seen = MOE.router_topk, []

    def record(logits, cfg):
        out = orig(logits, cfg)
        seen.append(out[2].reshape(-1, rows, cfg.top_k)[0].sort(-1).values)
        return out
    MOE.router_topk = record
    try:
        res = fn()
    finally:
        MOE.router_topk = orig
    return res, torch.stack(seen)


def drop_control(torch, params, twin, tok, pos, cache, leaves, span,
                 written):
    """The negative control: the twin's logits with the slots [lo, hi) =
    ``span`` of every attention leaf zeroed.  Afterwards the slots and
    each row's slot at ``pos`` (``written``, the twin's own write) are
    put back."""
    lo, hi = span
    saved = [t[:, :, lo:hi].clone() for t in leaves]
    for t in leaves:
        t[:, :, lo:hi] = 0
    lc, _ = twin(params, tok, pos, cache)
    rows = torch.arange(pos.shape[0], device=pos.device)
    for t, v, w in zip(leaves, saved, written):
        t[:, :, lo:hi] = v
        t[:, rows, pos] = w.to(t.dtype)
    return lc


def layout_pair(torch, cfg, params, layout, twin, tok, pos, cache, steps,
                drop, routes: bool = False, check: bool = True):
    """``steps`` greedy decode steps of ``layout`` from ids ``tok`` at
    ``pos``, each step's logits held against ``twin``'s (the gather-path
    decode) on the same cache and weights: both write the step's k / v at
    ``pos`` (the twin's last), the next token is the layout's greedy id.
    Per step: max |logit difference| / max |twin logit| within
    SERVE_REL_BOUND, and the greedy ids equal on every row whose twin
    top-two margin clears it.  The writes: the k / v the layout wrote at
    ``pos`` within the bound of the twin's (max over the slots, relative
    to the twin's), and the slot's content before the step outside it, so
    a write that missed its slot shows.  The control, at the first step:
    the twin with the cache slots ``drop`` = (lo, hi) zeroed
    (:func:`drop_control`) must read outside the bound against the
    layout, so the check sees a shard lost.  ``routes`` (an MoE in bf16,
    where two correct paths may route a token to other experts now and
    then): the logits and ids are held only on the rows whose top-k
    experts the two paths chose alike in every MoE layer (:func:`routed`),
    which must be at least ROUTE_SHARE of the rows.  ``check=False``
    reads without asserting.  Returns the readings and the state after
    the last step."""
    tok = torch.as_tensor(tok, device=DEVICE)
    pos = torch.as_tensor(pos, device=DEVICE)
    rows = int(tok.shape[0])
    leaves = attn_leaves(cache)
    tol, rels, decided, agree, margins = SERVE_REL_BOUND, [], 0, 0, []
    writes, unwritten, kept, control = [], [], [], None
    for i in range(steps):
        before = slots_at(torch, leaves, pos)
        (la, cache), ra = routed(torch, lambda: layout(
            params, tok, pos, cache), rows, routes)
        wrote = slots_at(torch, leaves, pos)
        (lb, cache), rb = routed(torch, lambda: twin(
            params, tok, pos, cache), rows, routes)
        written = slots_at(torch, leaves, pos)
        writes.append(rel_err(wrote, written))
        unwritten.append(rel_err(before, written))
        if i == 0:
            lc = drop_control(torch, params, twin, tok, pos, cache, leaves,
                              drop, written)
            control = rel_err(la[:, :cfg.vocab].float(),
                              lc[:, :cfg.vocab].float())
        la, lb = la[:, :cfg.vocab].float(), lb[:, :cfg.vocab].float()
        scale = float(lb.abs().max())
        same = torch.ones(rows, dtype=torch.bool, device=DEVICE) \
            if ra is None else (ra == rb).all(-1).all(0)
        kept.append(int(same.sum()))
        if kept[-1]:
            rels.append(float((la - lb).abs().amax(-1)[same].max()) / scale)
        top2 = lb.topk(2, dim=-1).values
        m = ((top2[:, 0] - top2[:, 1]) / scale)
        margins.append(float(m.min()))
        sure = (m > tol) & same
        decided += int(sure.sum())
        agree += int(((la.argmax(-1) == lb.argmax(-1)) & sure).sum())
        tok, pos = la.argmax(-1), pos + 1
    readings = {
        "steps": steps, "rel_err_max": max(rels, default=None),
        "rel_err": rels, "bound": tol, "decided_ids": decided,
        "ids_equal": agree, "min_margin": min(margins),
        "write_err_max": max(writes), "unwritten_min": min(unwritten),
        "control_slots": list(drop), "control_rel_err": control,
        "rows_routed_alike": kept if routes else None}
    if not check:
        return readings, (tok, pos, cache)
    assert sum(kept) >= ROUTE_SHARE * steps * rows, (
        "rows routed alike", cfg.name, kept)
    assert max(rels) <= tol, ("layout vs gather decode", cfg.name, rels, tol)
    assert agree == decided, ("greedy ids vs gather decode", cfg.name,
                              agree, decided)
    assert max(writes) <= tol < min(unwritten), (
        "layout's k / v writes vs the twin's", cfg.name, writes, unwritten)
    assert control > tol, ("control inside the bound", cfg.name, control)
    return readings, (tok, pos, cache)


def layout_timing(torch, cfg, params, steps, tok, pos, cache, rows):
    """ms a decode step (CUDA events), peak memory of one step above what
    is held, and the device-busy share (the kernels' summed device ms of
    a traced greedy step over its CUDA-event ms, :func:`dtoh_check`, which
    also asserts one DtoH copy of the ids, ``rows`` x 4 bytes) for each
    ``(name, raw step, greedy step)`` of ``steps``."""
    out = {}
    for name, raw, greedy in steps:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        raw(params, tok, pos, cache)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(lambda: greedy(params, tok, pos, cache), reps=5)
        dtoh = dtoh_check(torch, lambda: greedy(params, tok, pos,
                                                cache)[0].cpu(), rows * 4)
        out[name] = {"ms_per_step": ms, "peak_memory": peak,
                     "peak_above_held": peak - held,
                     "busy_share": dtoh["kernel_ms_per_step"] / ms,
                     "dtoh": dtoh}
    return out


def phase_serve_splitkv(torch):
    """Split-KV decode (the long_500k policy): qwen1.5-0.5b's ``swa``
    variant as published (window 4,096, tied, 24 layers, bf16) on
    SPLITKV["data"] data positions, one row, a cache of SPLITKV["slots"]
    slots (51.5 GB, each leaf a seeded normal draw x SPLITKV["fill"]),
    DECODE_STEPS greedy steps from SPLITKV["pos"], crossing the shard
    boundary at slots / data; then the base variant (no window) at SPLITKV_BASE's
    slots and rows, every shard in every row's reach.  Each step's logits
    against the batch-sharded decode of a one-position mesh on the same
    cache and weights, the writes and the control of zeroed slots
    SPLITKV["drop"] (:func:`layout_pair`); ms a step, peak memory and
    busy share of both (:func:`layout_timing`); the greedy split-KV step
    audited: integer ids out, no host read or DtoH copy inside."""
    from repro_torch.analysis import audit_serve_decode
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.step import (init_cache_global, make_decode_step,
                                        make_decode_greedy_step, mesh_ctx)
    torch.cuda.empty_cache()
    runs, launches = [], {}
    for spec in (SPLITKV, SPLITKV_BASE):
        cfg = get_config(SERVE_ARCH, spec["variant"])
        mc, one = mesh_ctx(spec["data"], device=DEVICE), mesh_ctx(1, device=DEVICE)
        params = T.init_params(cfg, 1, seed=0, device=DEVICE)
        rows, slots = spec["rows"], spec["slots"]
        cache = init_cache_global(cfg, mc, rows, slots, seq_sharded=True)
        fill_cache(torch, cache, 1, spec["fill"])
        tok = np.random.RandomState(2).randint(0, cfg.vocab, rows)
        pos = np.asarray(spec["pos"], np.int64)
        kw = dict(seq_sharded=True)
        layout = make_decode_step(cfg, mc, **kw)[0]
        twin = make_decode_step(cfg, one)[0]
        (readings, state), ran = main_path(lambda: layout_pair(
            torch, cfg, params, layout, twin, tok, pos, cache, DECODE_STEPS,
            spec["drop"]))
        launches = {k: launches.get(k, 0) + v for k, v in ran.items()}
        tok, pos, cache = state
        greedy = make_decode_greedy_step(cfg, mc, **kw)[0]
        timing = layout_timing(torch, cfg, params, (
            ("splitkv", layout, greedy),
            ("gather_one_position", twin,
             make_decode_greedy_step(cfg, one)[0])), tok, pos, cache, rows)
        audit = audit_serve_decode("splitkv_greedy", greedy, params, tok,
                                   pos, cache, vocab=cfg.vocab)
        assert audit.ok, audit.to_dict()
        runs.append({"variant": spec["variant"], "window": cfg.window,
                     "data": mc.data, "rows": rows, "slots": slots,
                     "cache_bytes": sum(t.numel() * t.element_size()
                                        for _, t in T.cache_leaves(cache)),
                     "first_pos": np.asarray(spec["pos"]).tolist(),
                     "shard_slots": slots // mc.data, "check": readings,
                     "timing": timing, "audit_ok": True})
        del params, cache, state, layout, twin, greedy
        torch.cuda.empty_cache()
    emit({"phase": "serve_splitkv", "ok": True, "arch": SERVE_ARCH,
          "layers": cfg.n_layers, "runs": runs,
          "checks": "each step's logits within SERVE_REL_BOUND x max |logit| "
                    "of the one-position batch-sharded decode on the same "
                    "cache, greedy ids equal where the margin clears it; "
                    "each step's k / v written at pos within the bound of "
                    "the twin's, the slot before outside it; the twin with "
                    "the slots 'drop' zeroed outside it; "
                    "the greedy step's audit (int32 ids, no vocab-sized "
                    "float output, no host read or DtoH copy inside); one "
                    "DtoH copy of rows x 4 bytes a step",
          "launches": launches})
    return launches


def serve2d_prefill(torch, cfg, mc, params, rows, prompt, max_seq):
    """The prefill of ``rows`` seeded rows of ``prompt`` tokens (and a
    VLM's seeded 0.02 x normal image embeddings) on ``mc``: ``(greedy
    ids, cache, first decode position)``."""
    from repro_torch.train.step import make_prefill_greedy_step
    rng = np.random.RandomState(3)
    batch = {"tokens": rng.randint(0, cfg.vocab, (rows, prompt))}
    if cfg.img_tokens:
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        batch["img_embeds"] = (torch.randn(
            (rows, cfg.img_tokens, cfg.d_model), generator=gen,
            device=DEVICE) * 0.02).to(cfg.dtype)
    pre = make_prefill_greedy_step(cfg, mc, max_seq)[0]
    ids, cache = pre(params, batch)
    return ids, cache, np.full(rows, prompt + cfg.img_tokens)


def serve2d_run(torch, phase, cfg, spec, twin_mesh=None,
                routes: bool = False):
    """serve2d at (data, model) = spec's against the gather-path decode on
    ``twin_mesh`` (default the same mesh), from the prefill cache of
    ``spec["rows"]`` rows (built on the twin's mesh): the phase's
    readings (:func:`layout_pair`, its control an empty cache: the prompt's
    slots zeroed; ``routes`` as there; :func:`layout_timing`), the MoE's
    dropped copies, launches."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.scheduler import moe_decode_drops_nothing
    from repro_torch.train.step import (make_decode_greedy_step,
                                        make_decode_step, mesh_ctx)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mc = mesh_ctx(spec["data"], spec["tp"], device=DEVICE)
    tm = twin_mesh or mc
    params = T.init_params(cfg, mc.tp, seed=0, device=DEVICE)
    weights = sum(t.numel() * t.element_size() for _, t in
                  T.tree_leaves(params))
    rows = spec["rows"]
    tok, cache, pos = serve2d_prefill(torch, cfg, tm, params, rows,
                                      spec["prompt"], spec["max_seq"])
    layout = make_decode_step(cfg, mc, serve2d=True)[0]
    twin = make_decode_step(cfg, tm)[0]
    (readings, state), launches = main_path(lambda: layout_pair(
        torch, cfg, params, layout, twin, tok, pos, cache, DECODE_STEPS,
        (0, int(pos.min())), routes=routes))
    drops = [float(d.max()) for d in layout.capture["moe_dropped"]]
    assert not drops or max(drops) == 0.0, ("serve2d MoE drops", drops)
    if cfg.n_experts:
        assert moe_decode_drops_nothing(cfg, -(-rows // tm.dp), tm.tp)
    tok, pos, cache = state
    peak = torch.cuda.max_memory_allocated()
    timing = layout_timing(torch, cfg, params, (
        ("serve2d", layout, make_decode_greedy_step(cfg, mc,
                                                     serve2d=True)[0]),
        ("gather", twin, make_decode_greedy_step(cfg, tm)[0])),
        tok, pos, cache, rows)
    line = {"phase": phase, "ok": True, "arch": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": str(cfg.dtype), "data": mc.data, "tp": mc.tp,
            "twin_mesh": [tm.data, tm.tp], "rows": rows,
            "prompt": spec["prompt"] + cfg.img_tokens,
            "max_seq": spec["max_seq"], "weight_bytes": weights,
            "check": readings, "timing": timing,
            "moe_dropped_max": max(drops) if drops else None,
            "peak_memory_prefill_and_steps": peak, "launches": launches}
    del params, cache, state, layout, twin
    torch.cuda.empty_cache()
    return line


def phase_serve_2d(torch):
    """serve2d of internvl2-26b as published (tied, 48 layers, d 6,144,
    FSDP, bf16; about 38.6 GB of weights) at (data, model) = SERVE2D's,
    4 rows of 1,024 stub image + 64 text tokens, DECODE_STEPS greedy
    steps against the gather-path decode of the same mesh
    (:func:`serve2d_run`)."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE2D["arch"])
    line = serve2d_run(torch, "serve_2d", cfg, SERVE2D)
    LAYOUT_PEAKS["serve_2d"] = line["peak_memory_prefill_and_steps"]
    emit(line)
    return line["launches"]


def phase_serve_2d_moe(torch):
    """serve2d of arctic-480b as published (tied, d 7,168, 128 experts
    top-2 beside a dense FFN, FSDP) at SERVE2D_MOE["layers"] of its 35
    layers (26.8 GB of bf16 experts a layer), (data, model) = (2, 2), 4
    rows of 64 tokens, against the gather-path decode of a one-position
    mesh on the same cache (the (2, 2) gather path's ``torch.matmul`` of
    the broadcast expert leaves copies them per position, 2 x 26.8 GB,
    which does not fit beside them); the decode drops no copy.  Held in
    float32 (53.6 GB of experts), as serve_ssm holds xlstm: in bf16 the
    two paths' activations part by about 1 % and flip a row's top-2 of
    128 experts now and then (a run on an NVIDIA H100 80GB HBM3 at
    700.00 W read 0.36 and 0.45 of max |logit| at 2 of 16 steps, about
    0.012 at the others).  Then the same in bf16, as arctic is published
    (line ``serve_2d_moe_bf16``), held on the rows both paths route
    alike (``layout_pair``'s ``routes``)."""
    from repro_torch.configs import get_config
    from repro_torch.train.step import mesh_ctx
    s = SERVE2D_MOE
    cfg, reduced = cut_depth(get_config(s["arch"]), s["layers"])
    one = mesh_ctx(1, 1, device=DEVICE)
    line = serve2d_run(torch, "serve_2d_moe", dataclasses.replace(
        cfg, dtype=torch.float32), s, twin_mesh=one)
    line["reduced"] = reduced + ["dtype bfloat16 -> float32"]
    emit(line)
    bf16 = serve2d_run(torch, "serve_2d_moe_bf16", cfg, s, twin_mesh=one,
                       routes=True)
    bf16["reduced"] = reduced
    emit(bf16)
    return {k: line["launches"].get(k, 0) + bf16["launches"].get(k, 0)
            for k in set(line["launches"]) | set(bf16["launches"])}


# reduced jamba's serve2d decode on the card against a CPU copy: the mamba
# block's bound in tests/test_torch_ssm.py (rtol 1e-4, atol 1e-5 x max)
HYBRID_2D_LIMITS = (1e-4, 1e-5)


def phase_serve_2d_hybrid(torch):
    """serve2d of reduced jamba-1.5-large-398b with ``fsdp=True`` (float32;
    ``mamba_decode_2d``, ``moe_ffn_2d``, ``attn_decode_2d`` and
    ``ffn_2d``) at (data, model) = (2, 2), 4 rows of 12 tokens, three
    teacher-forced decode steps on the card and on a CPU copy of its
    weights and prefill cache: every step's logits within
    HYBRID_2D_LIMITS (``excess`` <= 1), no MoE copy dropped."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_decode_step, mesh_ctx
    cfg = get_config(HYBRID_ARCH).reduced(fsdp=True)
    out = {}
    for dev in (DEVICE, "cpu"):
        mc = mesh_ctx(2, 2, device=dev)
        if dev == DEVICE:
            params = T.init_params(cfg, 2, seed=0, device=DEVICE)
            tok, cache, pos = serve2d_prefill(torch, cfg, mc, params, 4, 12,
                                              16)
            start = (params, tok, cache)
        else:
            params, tok, cache = (T.tree_from_leaves(
                t, [(k, v.cpu()) for k, v in T.tree_leaves(t)])
                if isinstance(t, dict) else t.cpu() for t in start)
        step = make_decode_step(cfg, mc, serve2d=True)[0]
        logits = []

        def run():
            nonlocal cache
            for i in range(3):
                lg, cache = step(params, tok, pos + i, cache)
                logits.append(lg.cpu())
        if dev == DEVICE:
            start = tuple(T.tree_from_leaves(t, [(k, v.clone()) for k, v in
                                                 T.tree_leaves(t)])
                          if isinstance(t, dict) else t.clone()
                          for t in start)
            _, launches = main_path(run)
            drops = [float(d.max()) for d in step.capture["moe_dropped"]]
        else:
            run()
        out[dev] = logits
    ex = max(excess(torch, a, b, HYBRID_2D_LIMITS)
             for a, b in zip(out[DEVICE], out["cpu"]))
    assert ex <= 1.0 and max(drops) == 0.0, (ex, drops)
    emit({"phase": "serve_2d_hybrid", "ok": True, "arch": cfg.name,
          "reduced": "ModelConfig.reduced(fsdp=True), float32",
          "data": 2, "tp": 2, "rows": 4, "steps": 3, "excess": ex,
          "limits": HYBRID_2D_LIMITS, "moe_dropped_max": max(drops),
          "check": "card vs CPU copy, every step's logits", "launches":
              launches})
    return launches


def phase_dryrun(torch):
    """The production-mesh dry run on meta tensors (``repro_torch.launch.
    dryrun``, 16 x 16 positions) of DRYRUN_PAIRS: every key, finite
    terms, the modeled memory within 80 GB; and the memory model's total
    for serve_2d's own shape (one position of its (2, 2) mesh) beside
    that phase's measured peak on the card (which holds the weights
    once, not a shard a position).  Host work only."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import run_pair
    from repro_torch.launch.memmodel import modeled_memory
    from repro_torch.train.step import mesh_ctx
    keys = ("mesh", "chips", "trace_s", "traced_flops", "traced_matmul_flops",
            "unfused_op_bytes", "collective_bytes", "exchanges",
            "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
            "model_flops_per_chip", "useful_compute_ratio", "fits_hbm")
    pairs = []
    for arch, shape, serve2d in DRYRUN_PAIRS:
        r = run_pair(arch, shape, False, "ring", None, serve2d=serve2d)
        assert r["fits_hbm"] and r["traced_flops"] > 0 and all(
            np.isfinite(r[k]) for k in ("t_compute_s", "t_memory_s",
                                        "t_collective_s")), r
        pairs.append(dict({k: r[k] for k in keys}, arch=arch, shape=shape,
                          serve2d=serve2d,
                          modeled_total=r["modeled_memory"]["total"]))
    s = SERVE2D
    mm = modeled_memory(get_config(s["arch"]), InputShape(
        "serve_2d", s["max_seq"], s["rows"], "decode"),
        mesh_ctx(s["data"], s["tp"], device="meta"))
    emit({"phase": "dryrun", "ok": True, "pairs": pairs,
          "serve_2d_memory": {"modeled_per_position": mm,
                              "positions": s["data"] * s["tp"],
                              "measured_peak": LAYOUT_PEAKS.get("serve_2d")},
          "constants": "H100 data sheet (core.netmodel): 989e12 bf16 "
                       "FLOP/s, 3.35e12 B/s HBM, 80e9 B, NVLink 450e9 B/s "
                       "each way"})
    return {}


def phase_audit(torch):
    """The dispatch audit sweep (``python -m repro_torch.analysis
    --audit``) on the card: every report clean; each engine run is one
    CUDA graph replay (``graph_launches`` + 1); the greedy decode step
    makes no host read or DtoH copy inside it.  Off the main path: the
    kernel launches it makes (the engines' SpMV at capture) are reported
    here, not in the kernels line."""
    from repro_torch.analysis.cli import audit_sweep
    from repro_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    reports = audit_sweep(DEVICE)
    bad = [r.to_dict() for r in reports if not r.ok]
    assert not bad, bad
    engines = [r for r in reports if r.target.startswith("GraphEngine")]
    assert engines and all(r.check("one_scan_dispatch").actual == 1
                           for r in engines)
    emit({"phase": "audit", "ok": True, "audits": [
        {"target": r.target, "checks": {c.check_id: c.actual
                                        for c in r.checks}}
        for r in reports], "seconds": time.perf_counter() - t0,
        "launches_off_main_path": {k: v - before.get(k, 0) for k, v in
                                   _build.LAUNCHES.items()
                                   if v != before.get(k, 0)}})
    return {}


def phase_soak_train(torch):
    """``python -m repro_torch.launch.soak --job train --reduced --dp 4
    --replication 2`` in subprocesses: a fault-free baseline, a run under
    a rack schedule from step 3 killed at step 4 (exit 17), and its
    ``--resume``; final.npz equal array by array and the same losses."""
    base_args = ["--job", "train", "--reduced", "--steps", "6",
                 "--ckpt-every", "2", "--batch", "4", "--seq", "32",
                 "--dp", "4", "--replication", "2", "--seed", "0",
                 "--pool", "16", "--device", DEVICE]
    rack = ["--faults", "rack", "--fault-at", "3", "--num-failures", "5",
            "--rack-size", "5"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}

    def soak(name, out, extra, rc):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.soak", "--out", out,
                               *base_args, *extra], env=env, cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == rc, (name, proc.returncode,
                                       proc.stdout[-2000:],
                                       proc.stderr[-4000:])
        runs[name] = {"seconds": time.perf_counter() - t0, "rc": rc}
        return proc.stdout

    base = os.path.join(SCRATCH["root"], "soak-train-base")
    faulted = os.path.join(SCRATCH["root"], "soak-train-faulted")
    soak("baseline", base, [], 0)
    out = soak("killed", faulted, rack + ["--kill-at", "4"], 17)
    assert "KILL step 4" in out, out
    out = soak("resumed", faulted, rack + ["--resume"], 0)
    assert "resumed at step 4" in out, out
    with np.load(os.path.join(base, "final.npz")) as a, \
            np.load(os.path.join(faulted, "final.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    metas = []
    for d in (base, faulted):
        with open(os.path.join(d, "final.meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0]["losses"] == metas[1]["losses"]
    assert metas[0]["events"] == [] and metas[1]["events"], metas[1]
    emit({"phase": "soak_train", "ok": True, "args": base_args + rack,
          "runs": runs, "events": metas[1]["events"],
          "losses": metas[0]["losses"],
          "tolerance": "final.npz (params, optimizer state) equal array by "
                       "array and losses equal to the fault-free baseline",
          "launches": {}})
    return {}


def bound_ms(nbytes: int) -> float:
    """Least milliseconds to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def index_add_call(torch, pos, val, num_rows):
    """One ``index_add_`` computing the same scatter (library yardstick),
    its flat destinations and buffer built outside the timed call."""
    b2 = pos.shape[0]
    flat = (torch.arange(b2, device=pos.device).unsqueeze(1) * (num_rows + 1)
            + torch.where((pos < 0) | (pos >= num_rows), num_rows,
                          pos.long())).reshape(-1)
    buf = torch.zeros(b2 * (num_rows + 1), val.shape[-1], device=pos.device)
    vflat = val.reshape(-1, val.shape[-1]).float()
    return lambda: buf.index_add_(0, flat, vflat)


def rank_timing(torch, runs, banded, calls):
    """One shape of a merge-rank kernel (``calls`` main-path calls there):
    exact against its plain version and the dense plain version, two calls
    bit-identical, then kernel, plain and library (``searchsorted`` over
    the same k*k run pairs) ms, the byte bound, and the CUDA launches and
    device ms per kernel stage of one call (profiler)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rank_merge import BM, BN, merge_ranks
    got = merge_ranks(runs, banded=banded)
    plain = lambda: ref.merge_ranks_ref(runs, (BM, BN) if banded else None)
    assert torch.equal(got, plain()), "merge ranks differ from plain"
    assert torch.equal(got, ref.merge_ranks_ref(runs)), "ranks differ"
    assert torch.equal(got, merge_ranks(runs, banded=banded)), "not repeatable"
    g, k, cap = runs.shape
    seq = runs.unsqueeze(1).expand(g, k, k, cap).contiguous()
    qry = runs.unsqueeze(2).expand(g, k, k, cap).contiguous()
    # calls of tens of microseconds need many reps to be timed; the
    # profiler runs after the timings (its tracing slows launches)
    reps = min(200, max(10, (1 << 25) // runs.numel()))
    out = {"shape": list(runs.shape), "launches": calls,
           "ms": cuda_ms(lambda: merge_ranks(runs, banded=banded), reps=reps,
                         warmup=5),
           "plain_ms": cuda_ms(plain, reps=3, warmup=1),
           "bound_ms": bound_ms(runs.numel() * 8 + got.numel() * 4),
           "library_ms": cuda_ms(lambda: torch.searchsorted(seq, qry),
                                 reps=max(3, reps // 4), warmup=2),
           "reps": reps}
    stages = fresh_profile(("repro_torch.kernels.rank_merge", "merge_ranks"),
                           (runs,), {"banded": banded})
    out["cuda_launches_per_call"] = sum(n for _, n in stages.values())
    out["stage_ms"] = {name: ms for name, (ms, _) in stages.items()}
    del seq, qry, got
    return out


def tile_counts_check(torch, runs):
    """The banded kernel's own full / skipped / frontier tile counts on
    ``runs`` equal ``rank_tile_stats`` summed over every group and ordered
    run pair (strict for s > r), computed on a CPU copy."""
    from repro_torch.kernels.rank_merge import merge_tile_stats
    got = merge_tile_stats(runs)
    want = merge_tile_stats(runs.cpu())
    assert got == want, (got, want)
    return got


def rank_row(torch, recorded, banded, launches):
    """A merge-rank kernel at every shape the main path handed it
    (``recorded``: [(runs, calls)], the layer-0 union_wire shape first),
    in the main path's launch form, against its plain version; the
    two-stream form (modes 0/1) checked on two runs of each shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rank_merge import rank_counts
    name = "rank_counts_banded" if banded else "rank_counts"
    shapes = []
    for runs, calls, phase in recorded:
        a, b = runs[:, 0].contiguous(), runs[:, 1].contiguous()
        for strict, side in ((True, "left"), (False, "right")):
            got = rank_counts(a, b, strict=strict, banded=banded)
            assert torch.equal(got, ref.rank_counts_ref(a, b, side)), \
                "counts differ"
            assert torch.equal(got, rank_counts(a, b, strict=strict,
                                                banded=banded)), "repeat"
        shapes.append(dict(rank_timing(torch, runs, banded, calls),
                           phase=phase))
    assert sum(e["launches"] for e in shapes) == launches[name], \
        (name, [e["launches"] for e in shapes], launches[name])
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  + ("rank_merge_banded.cu" if banded else "rank_merge.cu"),
        "replaces": "src/repro/kernels/rank_merge.py:"
                    + ("165" if banded else "142"),
        "launches": launches[name], "max_abs_err": 0,
        "check": "exact vs plain at every shape (the replica stage's k = 2 "
                 "and the survivors' flat k = 31 included), modes 0/1/2, "
                 "repeat identical",
        "bound_by": "bytes"}
    row.update({k: shapes[0][k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "library_ms")})
    row["shapes"] = shapes
    if banded:
        row["tile_counts"] = tile_counts_check(torch, recorded[0][0])
        row["check"] += ("; tile counts equal rank_tile_stats summed over "
                         "the layer-0 run pairs")
    return row


def general_inputs(torch, pos, val, scale):
    """General floats at the main path's positions: normal f32 / bf16
    values, or int8 values with a uniform (0, 1) scale."""
    gen = torch.Generator(device=pos.device).manual_seed(11)
    if scale is None:
        v = torch.randn(val.shape, generator=gen, device=pos.device)
        return v.to(val.dtype), None
    q = torch.randint(-127, 128, val.shape, generator=gen, device=pos.device,
                      dtype=torch.int32).to(torch.int8)
    return q, torch.rand(scale.shape, generator=gen, device=pos.device)


# profiler traces run in a fresh process (``fresh_profiler``): late in
# this script's own process, traces lost the device events of their first
# calls (runs S1, F, F2, F4 and R1 of PR 17), which a fresh process has
# not shown (tools/profiler_window.py: 513 whole traces in 4 minutes)
FRESH = {"proc": None, "jobs": None, "results": None, "calls": 0,
         "traces": 0}
PROFILER = {"traces": 0}


@contextlib.contextmanager
def fresh_profiler():
    """A fresh process that runs ``fresh_profile``'s jobs while the block
    runs; stopped when it ends."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    FRESH["jobs"], FRESH["results"] = ctx.Queue(), ctx.Queue()
    FRESH["proc"] = proc = ctx.Process(
        target=profiler_child, args=(FRESH["jobs"], FRESH["results"]),
        daemon=True)
    proc.start()
    try:
        yield
    finally:
        FRESH["jobs"].put(None)
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join()


def fresh_profile(target, args, kwargs=None, reps: int = 5):
    """``profile_kernels`` of one call of ``target`` in ``fresh_profiler``'s
    process: ``(module, name)`` names a function, ``(module, class, init
    kwargs, method)`` a method of a new instance; the tensors of ``args``
    and ``kwargs`` are shared with it through CUDA IPC, not copied."""
    FRESH["jobs"].put((target, args, kwargs or {}, reps))
    while True:
        try:
            status, out, traces = FRESH["results"].get(timeout=5)
            break
        except queue.Empty:
            if not FRESH["proc"].is_alive():
                raise RuntimeError("profiler process exited with code "
                                   f"{FRESH['proc'].exitcode}") from None
    if status != "ok":
        raise RuntimeError("profiler process failed:\n" + out)
    FRESH["calls"] += 1
    FRESH["traces"] += traces
    return out


def profiler_child(jobs, results):
    """``fresh_profiler``'s process: ``profile_kernels`` of each job until
    ``None``; a failure's traceback goes back to the caller, which
    raises."""
    import importlib
    import traceback
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    for target, args, kwargs, reps in iter(jobs.get, None):
        obj = getattr(importlib.import_module(target[0]), target[1])
        fn = getattr(obj(**target[2]), target[3]) if len(target) > 2 else obj
        before = PROFILER["traces"]
        try:
            stages = profile_kernels(torch, lambda: fn(*args, **kwargs), reps)
            # idle, the shared tensors released, before the caller goes on
            del args, kwargs, fn, obj
            torch.cuda.synchronize()
            results.put(("ok", stages, PROFILER["traces"] - before))
        except Exception:
            results.put(("error", traceback.format_exc(), 0))


def profile_kernels(torch, fn, reps: int = 5, tries: int = 5):
    """``{name: (device ms, launches)}`` per call of each kernel ``fn``
    launches (template instances summed under one name), from a
    ``torch.profiler`` trace of ``reps`` calls; only the device's own
    events count (an operator's or a launch call's device time is its
    kernels' again).  Each trace starts with a warm-up step of one call
    that is not recorded, and the calls sit 20 ms of host time inside the
    recorded window on both sides.  A trace is taken again, up to
    ``tries`` times in all, unless it holds device events and every
    kernel was launched the same whole number of times in each of the
    ``reps`` calls; otherwise this raises."""
    fn()
    torch.cuda.synchronize()
    counts = None
    for _ in range(tries):
        total = trace_once(torch, fn, reps)
        PROFILER["traces"] += 1
        if total and all(n % reps == 0 for _, n in total.values()):
            return {name: (ms / reps, n // reps)
                    for name, (ms, n) in total.items()}
        counts = {name: n for name, (_, n) in total.items()}
    raise RuntimeError(f"profiler: no whole trace of {reps} calls in {tries} "
                       f"tries; the last held {counts}")


def trace_once(torch, fn, reps: int) -> dict:
    """``{name: (device ms, launches)}`` summed over one profiler trace of
    ``reps`` calls of ``fn`` (after one unrecorded warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
        prof.step()
    total = {}
    for evt in traces.pop():
        if (evt.device_type == DeviceType.CPU
                or evt.key.startswith("ProfilerStep")):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            key = evt.key.replace("(anonymous namespace)::", "")
            key = key[5:] if key.startswith("void ") else key
            name = re.split(r"[<(]", key)[0].split("::")[-1]
            ms, n = total.get(name, (0.0, 0))
            total[name] = (ms + us / 1e3, n + evt.count)
    return total


def dense_scatter_large(torch, fn, pos, val, num_rows, scale):
    """The dense scatter at the union_wire layer-0 shape on general
    floats: bit for bit against its plain version on a CPU copy, two
    launches identical, its layout equal to a stable argsort; returns
    the check and ``index_add_``'s ms on the same inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import row_order
    gv, gs = general_inputs(torch, pos, val, scale)
    got = fn(pos, gv, num_rows, scale=gs)
    want = ref.onehot_scatter_add_ref(pos.cpu(), gv.cpu(), num_rows,
                                      None if gs is None else gs.cpu())
    assert torch.equal(got.cpu(), want), "dense scatter != plain on CPU"
    assert torch.equal(got, fn(pos, gv, num_rows, scale=gs)), "not repeatable"
    perm, off = row_order(pos, num_rows)
    wperm, woff = ref.row_order_ref(pos, num_rows)
    assert torch.equal(perm, wperm) and torch.equal(off, woff), "layout"
    del perm, off, wperm, woff, want, got
    return ("bit-exact vs plain on a CPU copy on general floats, repeat "
            "identical, layout equal to a stable argsort")


def scatter_row(torch, name, fn, args, kwargs, launches, library):
    """One scatter kernel on its recorded inputs vs its plain version:
    bit-exact on dyadic inputs; with a general scale, bit-exact against
    the plain version on the CPU (``index_add_`` there sums in source
    order, the kernel's) and within rtol 1e-6 + 1e-6 x max|out| of the
    plain version on the card (whose ``index_add_`` sums in atomic order,
    so sums that cancel to ~0 differ in absolute terms); two launches
    bit-identical."""
    from repro_torch.kernels import ref
    pos, val, num_rows = args
    scale = kwargs.get("scale")
    got = fn(*args, **kwargs)
    want = ref.onehot_scatter_add_ref(pos, val, num_rows, scale)
    if scale is None:
        assert torch.equal(got, want), f"{name} differs from plain"
        check = "bit-exact (dyadic), repeat identical"
    else:
        on_cpu = ref.onehot_scatter_add_ref(
            pos.cpu(), val.cpu(), num_rows, scale.cpu())
        assert torch.equal(got.cpu(), on_cpu), f"{name} differs from CPU plain"
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
        check = ("bit-exact vs plain on CPU; rtol 1e-6 + 1e-6 x max vs plain "
                 "on card (general scale); repeat identical")
    assert torch.equal(got, fn(*args, **kwargs)), f"{name} not repeatable"
    line = {"onehot_scatter_add": "80", "onehot_scatter_add_scaled": "58"}
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/onehot_scatter.cu",
        "replaces": "src/repro/kernels/onehot_scatter.py:" + line[name],
        "launches": launches[name],
        "max_abs_err": float((got - want).abs().max()), "check": check,
        **scatter_timing(torch, fn, args, kwargs, library)}


def scatter_timing(torch, fn, args, kwargs, library, reps: int = 10):
    """Shape, dtype, kernel / plain / library ms and byte bound of one
    scatter call."""
    from repro_torch.kernels import ref
    pos, val, num_rows = args
    scale = kwargs.get("scale")
    # every destination is read; values and scales of kept sources only
    kept = int(((pos >= 0) & (pos < num_rows)).sum())
    nbytes = (pos.numel() * 4 + kept * val.shape[-1] * val.element_size()
              + (0 if scale is None else kept * 4)
              + pos.shape[0] * num_rows * val.shape[-1] * 4)
    return {
        "shape": [pos.shape[0], pos.shape[1], int(val.shape[-1]),
                  int(num_rows)],
        "val_dtype": str(val.dtype).replace("torch.", ""),
        "ms": cuda_ms(lambda: fn(*args, **kwargs), reps=reps),
        "plain_ms": cuda_ms(lambda: ref.onehot_scatter_add_ref(
            pos, val, num_rows, scale), reps=10),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None if library is None else cuda_ms(library,
                                                           reps=reps)}


def banded_call(torch, args, kwargs, calls):
    """The banded scatter at one (layer, dtype) of the main path
    (``calls`` main-path calls there): bit-exact against its plain version
    (on the card for dyadic values, on a CPU copy with the int8 wire's
    general scales), two calls identical, its window table equal to
    ``searchsorted`` of the tile boundaries; kernel, plain and
    ``index_add_`` ms; the byte bound of what the kernel must move (the
    kept sources' ``pos``, values and scales, the window table and the
    output; the parked tail is never read) and, beside it, the bound over
    every ``pos`` entry; the CUDA launches (two) and device ms per stage
    of one call (profiler)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import (BANDED_ROWS,
                                                    banded_onehot_scatter_add,
                                                    banded_windows)
    pos, val, num_rows = args
    scale = kwargs.get("scale")
    fn = banded_onehot_scatter_add
    got = fn(*args, **kwargs)
    want = ref.onehot_scatter_add_ref(pos, val, num_rows, scale)
    if scale is None:
        assert torch.equal(got, want), "banded differs from plain"
        check = "bit-exact vs plain (dyadic)"
    else:
        on_cpu = ref.onehot_scatter_add_ref(pos.cpu(), val.cpu(), num_rows,
                                            scale.cpu())
        assert torch.equal(got.cpu(), on_cpu), "banded differs from CPU plain"
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
        check = ("bit-exact vs plain on a CPU copy (general scales); rtol "
                 "1e-6 + 1e-6 x max vs plain on card")
        del on_cpu
    err = float((got - want).abs().max())
    assert torch.equal(got, fn(*args, **kwargs)), "banded not repeatable"
    keys = torch.clamp(torch.arange(-(-num_rows // BANDED_ROWS) + 1,
                                    device=pos.device) * BANDED_ROWS,
                       max=num_rows).to(torch.int32)
    assert torch.equal(banded_windows(pos, num_rows), torch.searchsorted(
        pos, keys.expand(pos.shape[0], -1).contiguous())), "window table"
    kept = int(((pos >= 0) & (pos < num_rows)).sum())
    del got, want
    # the library yardstick: index_add_ of the (widened) values; for the
    # int8 wire it leaves out the scale, as row 4's does
    out = {"calls": calls, "check": check + "; repeat identical; window "
           "table = searchsorted", "max_abs_err": err, "kept_sources": kept,
           **scatter_timing(torch, fn, args, kwargs,
                            index_add_call(torch, pos, val, num_rows),
                            reps=50)}
    out["bound_all_pos_ms"] = out["bound_ms"]
    out["bound_ms"] = bound_ms(
        kept * (4 + val.shape[-1] * val.element_size()
                + (0 if scale is None else 4))
        + keys.numel() * pos.shape[0] * 8
        + pos.shape[0] * num_rows * val.shape[-1] * 4)
    stages = fresh_profile(("repro_torch.kernels.onehot_scatter",
                            "banded_onehot_scatter_add"), args, kwargs)
    out["cuda_launches_per_call"] = sum(n for _, n in stages.values())
    assert out["cuda_launches_per_call"] == 2, stages
    out["stage_ms"] = {name: ms for name, (ms, _) in stages.items()}
    return out


def note_merge_steps(merge: str, wire: str, n: int) -> None:
    """Count ``n`` sparse steps of the current phase that ran ``merge``
    on ``wire`` (a train phase's syncs, a serve phase's dispatch)."""
    key = (PHASE["name"], merge, wire == "delta+int8ef")
    MERGE_STEPS[key] = MERGE_STEPS.get(key, 0) + n


def merge_steps(phase: str, merge: str, scaled: bool) -> int:
    """The sparse steps of ``phase`` that ran ``merge`` (with the int8
    wire's scales or without), its repeat included."""
    return MERGE_STEPS.get((phase, merge, scaled), 0)


def train_scatter_shapes(torch, rec, name, banded, launches,
                         phases=TRAIN_PHASES):
    """A scatter kernel at every shape the train phases handed it (one per
    phase and butterfly layer; ``val`` [M, k * cap, w] float32 rows of the
    embedding gradient, w = 1,024, 1,536 or 2,048, or int8 + scale): bit for bit against its plain
    version on a CPU copy (which sums in source order, the kernel's), within
    rtol 1e-6 + 1e-6 x max of the plain version on the card (atomic
    ``index_add_`` sums), two calls identical; calls and launches a step;
    kernel, plain and ``index_add_`` ms; the byte bound (kept sources' pos,
    values and scales, the output; banded: also the window table); the
    CUDA launches and device ms per stage (profiler)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import (BANDED_ROWS,
                                                    banded_onehot_scatter_add,
                                                    onehot_scatter_add)
    fn = banded_onehot_scatter_add if banded else onehot_scatter_add
    scaled = name.endswith("_scaled")
    keys = sorted((k for k in rec.args if k[0] in phases
                   and (k[1] == "scaled") == scaled),
                  key=lambda k: (ROW_PHASES.index(k[0]), k[-1][1]))
    out = []
    for key in keys:
        n_steps = merge_steps(key[0], "banded" if banded else "fused", scaled)
        args, kwargs = rec.args[key]
        pos, val, num_rows = args
        scale = kwargs.get("scale")
        got = fn(*args, **kwargs)
        on_cpu = ref.onehot_scatter_add_ref(
            pos.cpu(), val.cpu(), num_rows,
            None if scale is None else scale.cpu())
        assert torch.equal(got.cpu(), on_cpu), (name, key, "vs CPU plain")
        want = ref.onehot_scatter_add_ref(pos, val, num_rows, scale)
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
        assert torch.equal(got, fn(*args, **kwargs)), (name, "repeat")
        err = float((got - want).abs().max())
        del got, want, on_cpu
        kept = int(((pos >= 0) & (pos < num_rows)).sum())
        entry = {"phase": key[0], "calls": rec.calls[key],
                 "launches_per_step": rec.calls[key] / n_steps,
                 "max_abs_err": err, "kept_sources": kept,
                 "check": "bit-exact vs plain on a CPU copy (general "
                          "floats); rtol 1e-6 + 1e-6 x max vs plain on card; "
                          "repeat identical",
                 **scatter_timing(torch, fn, args, kwargs,
                                  index_add_call(torch, pos, val, num_rows),
                                  reps=20)}
        if banded:
            tiles = -(-num_rows // BANDED_ROWS) + 1
            entry["bound_all_pos_ms"] = entry["bound_ms"]
            entry["bound_ms"] = bound_ms(
                kept * (4 + val.shape[-1] * val.element_size()
                        + (0 if scale is None else 4))
                + tiles * pos.shape[0] * 8
                + pos.shape[0] * num_rows * val.shape[-1] * 4)
        stages = fresh_profile(("repro_torch.kernels.onehot_scatter",
                                fn.__name__), args, kwargs)
        entry["cuda_launches_per_call"] = sum(n for _, n in stages.values())
        entry["stage_ms"] = {k: ms for k, (ms, _) in stages.items()}
        out.append(entry)
    assert out and sum(e["calls"] for e in out) == launches[name], \
        (name, [e["calls"] for e in out], launches[name])
    return out


def banded_rows(torch, rec, launches, train_launches):
    """Rows 5 and 6: the banded scatter at every (phase, butterfly layer,
    value dtype) the main path handed it, union_wire's layer 0 first; each
    row's top-level numbers are that call's (f32, or int8 + scale); the
    train phase's shapes (general floats, w = 1,024) in ``train``."""
    rows = []
    for name, kinds in (("banded_onehot_scatter_add", ("f32", "bf16")),
                        ("banded_onehot_scatter_add_scaled", ("scaled",))):
        keys = sorted((k for k in rec.args if k[1] in kinds
                       and k[0] not in TRAIN_PHASES),
                      key=lambda k: (ROW_PHASES.index(k[0]), k[2][1],
                                     kinds.index(k[1])))
        shapes = [dict(banded_call(torch, *rec.args[k], rec.calls[k]),
                       phase=k[0]) for k in keys]
        train = train_scatter_shapes(torch, rec, name, True, train_launches)
        assert sum(e["calls"] for e in shapes + train) == launches[name], \
            (name, [e["calls"] for e in shapes + train], launches[name])
        line = "177" if name == "banded_onehot_scatter_add" else "156"
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/banded_onehot_scatter.cu",
            "replaces": "src/repro/kernels/onehot_scatter.py:" + line,
            "launches": launches[name],
            "max_abs_err": max(e["max_abs_err"] for e in shapes),
            "check": "bit-exact at every (layer, dtype) of the main path: "
                     "dyadic vs plain, scaled vs plain on a CPU copy (and "
                     "rtol 1e-6 vs plain on card); repeat identical; window "
                     "table = searchsorted",
            **{k: shapes[0][k] for k in ("shape", "val_dtype", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "bound_all_pos_ms")},
            "shapes": shapes, "train": train})
    return rows


def csr_library(torch, row_ptr, cols, wts, x):
    """One library CSR matvec over the same nonzeros (block-diagonal CSR of
    all nodes times the flattened x): ``(call, its result)``."""
    m, n = x.shape
    r = row_ptr.numel() - 1
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    node = torch.repeat_interleave(
        torch.arange(r, device=x.device) // (r // m), lens)
    csr = torch.sparse_csr_tensor(row_ptr.long(), cols.long() + node * n, wts,
                                  size=(r, m * n))
    xv = x.reshape(-1, 1)
    call = lambda: csr @ xv
    return call, call().reshape(m, r // m)


def csr_product64(torch, row_ptr, cols, wts, x, absolute=False):
    """The stacked-CSR product in float64 (of |A| and |x| with
    ``absolute``), [M, n_rows]: the exact sum to hold a float32 one to,
    and the scale its rounding grows with."""
    m, r = x.shape[0], row_ptr.numel() - 1
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(r, device=x.device), lens)
    xi = (row // (r // m)) * x.shape[-1] + cols.long()
    w, xv = wts.double(), x.reshape(-1).double()[xi]
    prod = (w.abs() * xv.abs()) if absolute else w * xv
    return torch.zeros(r, dtype=torch.float64, device=x.device).index_add_(
        0, row, prod).reshape(m, r // m)


def spmv_csr_call(torch, args, calls, first):
    """The SpMV kernel on one graph phase's first-round inputs (``calls``
    main-path launches there), repeat identical.  PageRank's first graph
    (``first``): within rtol 1e-5 of the plain version and the library
    CSR matvec.  The others: within 1e-5 x (|A| |x|) + 1e-9 per row of
    the float64 product, and 1e-4 x (|A| |x|) + 1e-9 of the plain version
    and the library, whose float32 sums run in atomic order (spectral's x
    has both signs, so its rows cancel, and |A| |x|, not the result, sets
    the rounding; where x >= 0 the two are equal)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_csr import spmv_csr
    row_ptr, cols, wts, x, bins = args
    got = spmv_csr(row_ptr, cols, wts, x, bins)
    plain = lambda: ref.spmv_csr_ref(row_ptr, cols, wts, x)
    want = plain()
    library, lib = csr_library(torch, row_ptr, cols, wts, x)
    if first:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
        torch.testing.assert_close(lib, got, rtol=1e-5, atol=1e-9)
        check = "rtol 1e-5 vs plain and vs CSR library"
    else:
        scale = csr_product64(torch, row_ptr, cols, wts, x, absolute=True)
        exact = csr_product64(torch, row_ptr, cols, wts, x)
        for other, rtol in ((exact, 1e-5), (want, 1e-4), (lib, 1e-4)):
            gap = float(((got.double() - other).abs() - rtol * scale).max())
            assert gap <= 1e-9, (rtol, gap)
        check = ("within 1e-5 x (|A| |x|) of the float64 product, 1e-4 x "
                 "(|A| |x|) of plain and CSR library")
        del scale, exact
    assert torch.equal(got, spmv_csr(row_ptr, cols, wts, x, bins)), \
        "spmv_csr not repeatable"
    nnz = int(cols.numel())
    nbytes = (nnz * 8 + row_ptr.numel() * row_ptr.element_size()
              + x.numel() * 4 + got.numel() * 4)
    return {
        "launches": calls, "max_abs_err": float((got - want).abs().max()),
        "check": check + ", repeat identical",
        "shape": [int(row_ptr.numel() - 1), int(x.shape[-1])], "nnz": nnz,
        "bins": int(bins.numel() - 1),
        "ms": cuda_ms(lambda: spmv_csr(row_ptr, cols, wts, x, bins), reps=20),
        "plain_ms": cuda_ms(plain, reps=5, warmup=1),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": cuda_ms(library, reps=20)}


def spmv_csr_row(torch, rec, launches):
    """The SpMV kernel at each graph phase's first round on the stacked
    CSR (main path); the top-level numbers are PageRank's.  A phase's
    launches are the kernels its main path ran (``GRAPH_RAN``): its
    warm-up rounds, and its graph replays times the SpMV kernels a traced
    replay ran.  Its wrapper calls (``wrapper_calls``: the warm-up rounds
    and the rounds each capture enqueued) sum to ``launches``'s count."""
    keys = sorted(rec.args, key=lambda key: GRAPH_PHASES.index(key[0]))
    assert sorted(k[0] for k in keys) == sorted(GRAPH_RAN), \
        (keys, GRAPH_RAN)
    shapes = [dict(spmv_csr_call(torch, rec.args[key][0], GRAPH_RAN[key[0]],
                                 key[0] == "pagerank"), phase=key[0],
                   wrapper_calls=rec.calls[key])
              for key in keys]
    assert sum(e["wrapper_calls"] for e in shapes) == launches["spmv_csr"], \
        ([e["wrapper_calls"] for e in shapes], launches["spmv_csr"])
    row = {"name": "spmv_csr", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/spmv_csr.cu",
           "replaces": "src/repro/kernels/spmv_ell.py:34",
           "launches": sum(e["launches"] for e in shapes),
           "max_abs_err": max(e["max_abs_err"] for e in shapes),
           "check": "; ".join(f"{e['phase']}: {e['check']}"
                              for e in shapes)}
    row.update({k: shapes[0][k] for k in ("shape", "nnz", "bins", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")})
    row["shapes"] = shapes
    return row


def spmv_ell_row(torch, parts, row_ptr, cols, wts, x, launches):
    """The ELL kernel, off the main path: stacked ELL tables of the same
    partitions built for this row alone (and freed after), the first
    round's x, against its plain version and the CSR library matvec."""
    from repro_torch.graph.engine import stack_ell
    from repro_torch.graph.pagerank import LazyTables
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_ell import spmv_ell
    m, n = x.shape
    u_cap = (row_ptr.numel() - 1) // m
    ec, ew = stack_ell(LazyTables(parts, "ell"), u_cap,
                       kmax=max(p.ell_width() for p in parts), device=DEVICE,
                       n_cols=n)
    got = spmv_ell(ec, ew, x)
    step = 8  # plain version in slices of nodes (its gathers are large)
    plain = lambda: torch.cat([ref.spmv_ell_ref(
        ec[i:i + step], ew[i:i + step], x[i:i + step])
        for i in range(0, m, step)])
    want = plain()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
    library, lib = csr_library(torch, row_ptr, cols, wts, x)
    torch.testing.assert_close(lib, got, rtol=1e-5, atol=1e-9)
    nnz = int(cols.numel())
    row = {
        "name": "spmv_ell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmv_ell.cu",
        "replaces": "src/repro/kernels/spmv_ell.py:34",
        "launches": launches["spmv_ell"], "main_path": False,
        "max_abs_err": float((got - want).abs().max()),
        "check": "rtol 1e-5 vs plain and vs CSR library",
        "shape": list(ec.shape), "nnz": nnz,
        "ell_bytes": int(ec.numel() * 8),
        "ms": cuda_ms(lambda: spmv_ell(ec, ew, x), reps=5),
        "plain_ms": cuda_ms(plain, reps=2, warmup=1),
        "bound_ms": bound_ms(nnz * 8 + x.numel() * 4 + got.numel() * 4),
        "bound_by": "bytes",
        "library_ms": cuda_ms(library, reps=5)}
    del ec, ew, got, want
    torch.cuda.empty_cache()
    return row


def float_bits(torch, t):
    """The raw bits of a tensor (-0.0 and 0.0 differ)."""
    if not t.dtype.is_floating_point:
        return t
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def trim_call(torch, args, calls):
    """The run compaction on one recorded main-path call (``calls``
    main-path calls of its shape): bit for bit equal to its plain version
    (the former scan-and-scatter trim, on the card), two calls
    identical; the kernel's and the plain version's ms, and the byte
    bound: each kept row read once and every output slot written once."""
    from repro_torch.core.sparse_vec import SENTINEL
    from repro_torch.kernels import ref
    from repro_torch.kernels.trim_runs import trim_runs
    idx, val, run, cap = args
    got = trim_runs(*args)
    want = ref.trim_runs_ref(*args)
    assert torch.equal(got[0], want[0]), "trim idx differs from plain"
    assert torch.equal(float_bits(torch, got[1]),
                       float_bits(torch, want[1])), "trim values differ"
    again = trim_runs(*args)
    assert torch.equal(got[0], again[0]) and torch.equal(
        float_bits(torch, got[1]), float_bits(torch, again[1])), "repeat"
    b, c = math.prod(idx.shape[:-1]), idx.shape[-1]
    counts = (idx.reshape(b, c // run, run) != SENTINEL).sum(-1)
    kept = int(counts.sum(-1).clamp(max=cap).sum())
    row_bytes = 8 + val[(0,) * idx.ndim].numel() * val.element_size()
    del got, want, again
    reps = min(100, max(5, (1 << 27) // idx.numel()))
    return {"shape": list(val.shape), "run_length": run, "runs": c // run,
            "cap": cap, "val_dtype": str(val.dtype), "kept_rows": kept,
            "launches": calls,
            "ms": cuda_ms(lambda: trim_runs(*args), reps=reps, warmup=2),
            "plain_ms": cuda_ms(lambda: ref.trim_runs_ref(*args), reps=3,
                                warmup=1),
            "bound_ms": bound_ms((kept + b * cap) * row_bytes),
            "bound_by": "bytes", "reps": reps}


def trim_row(torch, rec, launches):
    """The run compaction at every (phase, shape) the main path handed it
    on the card, union_wire's (the mini-batch scale) first; the top-level
    numbers are that call's, with its CUDA launches and device ms per
    kernel stage (profiler).  The calls sum to the main path's launches;
    CPU calls (the plain version, no launch) are counted apart."""
    keys = [key for key in rec.args if key[1] == "cuda"]
    keys.sort(key=lambda key: (ROW_PHASES.index(key[0])
                               if key[0] in ROW_PHASES else len(ROW_PHASES),
                               key[0], -math.prod(key[3])))
    shapes = [dict(trim_call(torch, rec.args[key][0], rec.calls[key]),
                   phase=key[0]) for key in keys]
    by_phase = {}
    for e in shapes:
        by_phase[e["phase"]] = by_phase.get(e["phase"], 0) + e["launches"]
    assert sum(by_phase.values()) == launches["trim_runs"], \
        (by_phase, launches["trim_runs"])
    first = shapes[0]
    stages = fresh_profile(("repro_torch.kernels.trim_runs", "trim_runs"),
                           rec.args[keys[0]][0])
    first["cuda_launches_per_call"] = sum(n for _, n in stages.values())
    first["stage_ms"] = {name: ms for name, (ms, _) in stages.items()}
    assert first["cuda_launches_per_call"] == 2, stages
    return {"name": "trim_runs", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trim_runs.cu",
            "replaces": "no TPU kernel: the union path's scan-and-scatter "
                        "trim (the plain version)",
            "launches": launches["trim_runs"], "max_abs_err": 0,
            "check": "bit for bit = plain (the former trim) at every "
                     "main-path shape, repeat identical",
            **{k: first[k] for k in ("shape", "val_dtype", "ms", "plain_ms",
                                     "bound_ms", "bound_by",
                                     "cuda_launches_per_call", "stage_ms")},
            "launches_by_phase": by_phase,
            "cpu_calls": sum(n for key, n in rec.calls.items()
                             if key[1] != "cuda"),
            "shapes": shapes}


def rank_shapes(rec, kind):
    """[(runs, main-path calls, phase)] of one merge-rank kernel, one per
    (phase, shape): union_wire's first, in butterfly-layer order, then
    replicated_union's (its degree-2 replica stage first), then union's."""
    keys = [key for key in rec.args if key[1] == kind]
    keys.sort(key=lambda key: ROW_PHASES.index(key[0]))
    return [(rec.args[key][0][0], rec.calls[key], key[0]) for key in keys]


def kernel_rows(torch, rec, launches, parts, train_launches,
                serve_launches):
    """Every kernel on its recorded main-path inputs vs its plain version,
    in the order of the TPU kernel table, then the run compaction;
    ``train_launches`` are the train phases' own counts, summed (their
    shapes are checked on general floats), and ``serve_launches`` the
    serve phases' (the dispatch's tail unions: the dense scatters'
    ``serve`` entries)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_scatter import onehot_scatter_add
    scat = rec["scatter"].args
    rows = [rank_row(torch, rank_shapes(rec["rank"], kind), kind == "banded",
                     launches) for kind in ("dense", "banded")]
    for row, merge in zip(rows, ("fused", "banded")):
        for e in row["shapes"]:
            n_steps = merge_steps(e["phase"], merge, False) \
                + merge_steps(e["phase"], merge, True)
            if n_steps:
                e["launches_per_step"] = e["launches"] / n_steps
    args, kwargs = scat[("union", "f32")]
    row = scatter_row(torch, "onehot_scatter_add", onehot_scatter_add, args,
                      kwargs, launches, index_add_call(torch, *args))
    (pos, val, num_rows), kw = scat[("union_wire", "bf16")]
    assert torch.equal(onehot_scatter_add(pos, val, num_rows, **kw),
                       ref.onehot_scatter_add_ref(pos, val, num_rows)), "bf16"
    row["large"] = {
        "check": dense_scatter_large(torch, onehot_scatter_add, pos, val,
                                     num_rows, None)
        + "; bit-exact vs plain on card (dyadic)",
        "stage_ms": {name: ms for name, (ms, _) in fresh_profile(
            ("repro_torch.kernels.onehot_scatter", "onehot_scatter_add"),
            (pos, val, num_rows), kw).items()},
        "dropped_sources": int(((pos < 0) | (pos >= num_rows)).sum()),
        **scatter_timing(torch, onehot_scatter_add, (pos, val, num_rows), kw,
                         index_add_call(torch, pos, val, num_rows))}
    args, kwargs = scat[("replicated_union", "f32")]
    row["replica_stage"] = dict(
        scatter_row(torch, "onehot_scatter_add", onehot_scatter_add, args,
                    kwargs, launches, index_add_call(torch, *args)),
        calls=rec["scatter"].calls[("replicated_union", "f32")])
    for key in ("name", "route", "source", "replaces", "launches"):
        del row["replica_stage"][key]
    # the survivors' flat layer of 31 runs (resilient_union, fused)
    ((_, _, (_, k31, cap31)),) = [key for key in rec["rank"].args
                             if key[0] == "resilient_union"
                             and key[1] == "dense" and key[2][1] > 2]
    (skey,) = [key for key in scat if key[:2] == ("resilient_union", "f32")
               and key[2][1] == k31 * cap31]
    args, kwargs = scat[skey]
    row["survivor_layer"] = dict(
        scatter_row(torch, "onehot_scatter_add", onehot_scatter_add, args,
                    kwargs, launches, index_add_call(torch, *args)),
        calls=rec["scatter"].calls[skey], k=k31)
    for key in ("name", "route", "source", "replaces", "launches"):
        del row["survivor_layer"][key]
    row["train"] = train_scatter_shapes(torch, rec["scatter"],
                                        "onehot_scatter_add", False,
                                        train_launches)
    row["serve"] = train_scatter_shapes(torch, rec["scatter"],
                                        "onehot_scatter_add", False,
                                        serve_launches, SERVE_PHASES)
    rows.append(row)
    args, kwargs = scat[("union_wire", "scaled")]
    row = scatter_row(torch, "onehot_scatter_add_scaled", onehot_scatter_add,
                      args, kwargs, launches, index_add_call(torch, *args))
    row["check"] += "; " + dense_scatter_large(
        torch, onehot_scatter_add, *args, kwargs["scale"])
    row["train"] = train_scatter_shapes(torch, rec["scatter"],
                                        "onehot_scatter_add_scaled", False,
                                        train_launches)
    row["serve"] = train_scatter_shapes(torch, rec["scatter"],
                                        "onehot_scatter_add_scaled", False,
                                        serve_launches, SERVE_PHASES)
    rows.append(row)
    rows.extend(banded_rows(torch, rec["banded"], launches, train_launches))
    csr_args = rec["spmv"].args[("pagerank", "first")][0]
    rows.append(spmv_ell_row(torch, parts, *csr_args[:4], launches))
    rows.append(spmv_csr_row(torch, rec["spmv"], launches))
    rows.append(trim_row(torch, rec["trim"], launches))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--plan-cache-probe"]:
        return plan_cache_probe(*sys.argv[2:5])
    SCRATCH["root"] = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return smoke(torch)
    finally:
        shutil.rmtree(SCRATCH["root"], ignore_errors=True)


def smoke(torch) -> int:
    """Every phase, then the kernels line and the last line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data.pipeline import powerlaw_graph
    from repro_torch.core import allreduce
    from repro_torch.graph import engine
    from repro_torch.graph.pagerank import build_partitions
    from repro_torch.kernels import _build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in open(str(lib) + ".log")
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})
    t0 = time.perf_counter()
    edges = powerlaw_graph(N_VERTICES, N_EDGES, alpha=2.0, seed=0)
    parts = build_partitions(edges, N_VERTICES, M)
    graph_s = time.perf_counter() - t0

    rec = {"rank": Recorder(ops, "merge_ranks", rank_variant),
           "scatter": Recorder(ops, "onehot_scatter_add", scatter_variant),
           "banded": Recorder(ops, "banded_onehot_scatter_add",
                              banded_variant),
           "spmv": Recorder(engine, "spmv_csr",
                            lambda a, kw: (PHASE["name"], "first")),
           "trim": Recorder(allreduce, "trim_runs", trim_variant)}

    seconds, parked = {}, {}

    def run(name, fn, *args):
        PHASE["name"] = name
        fresh_plan_cache()
        t0 = time.perf_counter()
        out = fn(torch, *args)
        seconds[name] = time.perf_counter() - t0
        # the phase's recorded inputs wait on the host until the rows
        t0 = time.perf_counter()
        moved = sum(r.move("cpu") for r in rec.values())
        parked[name] = {"bytes": moved, "s": time.perf_counter() - t0}
        return out

    per_phase = {"planned": run("planned", phase_planned, parts),
                 "union": run("union", phase_union),
                 "pagerank": run("pagerank", phase_pagerank, edges, parts,
                                 N_VERTICES),
                 "hadi": run("hadi", phase_hadi, edges, parts, N_VERTICES),
                 "spectral": run("spectral", phase_spectral, edges,
                                 N_VERTICES)}
    t0 = time.perf_counter()
    big = powerlaw_graph(LARGE_VERTICES, LARGE_EDGES, alpha=2.0, seed=0)
    big_parts = build_partitions(big, LARGE_VERTICES, M)
    emit({"phase": "pagerank_large_graph", "seconds":
          time.perf_counter() - t0})
    per_phase["pagerank_large"] = run("pagerank_large", phase_pagerank, big,
                                      big_parts, LARGE_VERTICES)
    del big, big_parts
    per_phase["union_wire"] = run("union_wire", phase_union_wire)
    per_phase["replicated_planned"] = run("replicated_planned",
                                          phase_replicated_planned, parts)
    per_phase["replicated_union"] = run("replicated_union",
                                        phase_replicated_union)
    per_phase["plan_cache"] = run("plan_cache", phase_plan_cache, parts)
    per_phase["calibrate"] = run("calibrate", phase_calibrate, parts)
    per_phase["resilient_planned"] = run("resilient_planned",
                                         phase_resilient_planned, parts)
    per_phase["resilient_union"] = run("resilient_union",
                                       phase_resilient_union)
    per_phase["supervised_pagerank"] = run("supervised_pagerank",
                                           phase_supervised_pagerank, parts)
    per_phase["soak_resume"] = run("soak_resume", phase_soak_resume)
    per_phase["train"] = run("train", phase_train)
    per_phase["train_tp"] = run("train_tp", phase_train_tp)
    per_phase["train_pod"] = run("train_pod", phase_train_pod)
    per_phase["train_long"] = run("train_long", phase_train_long)
    per_phase["train_overlap"] = run("train_overlap", phase_train_overlap)
    per_phase["soak_train"] = run("soak_train", phase_soak_train)
    per_phase["train_moe"] = run("train_moe", phase_train_moe)
    per_phase["train_ssm"] = run("train_ssm", phase_train_ssm)
    per_phase["train_encdec"] = run("train_encdec", phase_train_encdec)
    per_phase["train_vlm"] = run("train_vlm", phase_train_vlm)
    per_phase["serve"] = run("serve", phase_serve)
    per_phase["serve_moe"] = run("serve_moe", phase_serve_moe)
    per_phase["serve_ssm"] = run("serve_ssm", phase_serve_ssm)
    per_phase["serve_encdec"] = run("serve_encdec", phase_serve_encdec)
    per_phase["serve_splitkv"] = run("serve_splitkv", phase_serve_splitkv)
    per_phase["serve_2d"] = run("serve_2d", phase_serve_2d)
    per_phase["serve_2d_moe"] = run("serve_2d_moe", phase_serve_2d_moe)
    per_phase["serve_2d_hybrid"] = run("serve_2d_hybrid",
                                       phase_serve_2d_hybrid)
    per_phase["audit"] = run("audit", phase_audit)
    per_phase["dryrun"] = run("dryrun", phase_dryrun)
    torch.cuda.synchronize()
    launches = {k: sum(p.get(k, 0) for p in per_phase.values())
                for k in _build.LAUNCHES}
    for r in rec.values():
        r.restore()
    emit({"phase": "main_path_launches", "launches": launches,
          "per_phase": per_phase, "graph_s": graph_s,
          "phase_seconds": seconds, "graph_spmv_ran": GRAPH_RAN,
          "note": "in-process main-path calls of the kernel wrappers (a "
                  "graph's kernels count once, at its capture; "
                  "graph_spmv_ran counts the SpMV kernels the graph phases "
                  "ran); the soak's subprocess launches are in its phase "
                  "line"})
    # off the main path: the ELL kernel (PageRank runs the CSR kernel), the
    # dense scatter's layout stages and the banded scatter's window table,
    # each launched on its own
    off_path = ("spmv_ell", "row_order", "banded_windows")
    assert all(launches[k] == 0 for k in off_path), launches
    assert all(v > 0 for k, v in launches.items() if k not in off_path), \
        launches

    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unparked = sum(r.move(DEVICE) for r in rec.values())
    emit({"phase": "kernels_start", "memory_allocated":
          torch.cuda.memory_allocated(), "memory_reserved_before": reserved,
          "memory_reserved": torch.cuda.memory_reserved(),
          "recorded_inputs": {"parked": parked, "back_bytes": unparked,
                              "back_s": time.perf_counter() - t0}})
    train_launches = {k: sum(per_phase.get(p, {}).get(k, 0)
                             for p in TRAIN_PHASES) for k in launches}
    serve_launches = {k: sum(per_phase.get(p, {}).get(k, 0)
                             for p in SERVE_PHASES) for k in launches}
    t0 = time.perf_counter()
    with fresh_profiler():
        rows = kernel_rows(torch, rec, launches, parts, train_launches,
                           serve_launches)
    emit({"phase": "profiler", "process": "fresh", "calls": FRESH["calls"],
          "traces": FRESH["traces"],
          "in_process_traces": PROFILER["traces"]})
    emit({"phase": "timing", "kernels_s": time.perf_counter() - t0,
          "total_s": time.perf_counter() - T_START})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
