"""Union reduces of mini-batch gradients on the port's union path.

Set-up draws a pool of batches on the device from the seed: every node
holds the endpoints of ``edges_per_node`` edges drawn as the
configuration's graph draws its edges (both ends from its rank law over
its ``vertices``: ``generate.rank_cdf``), with dyadic float32 values,
hashed, coalesced, sorted and SENTINEL-padded into ``capacity`` slots
(``generate.hashed_layout``).  The union holds at most ``vertices`` ids,
the reduce's out capacity.  A unit is one
``SparseAllreduce.union_reduce`` of the next batch of the pool (each
reduce a different batch than the one before), then a synchronisation:
the learner waits for its reduced gradient (a closed loop).

The check: every reduce's overflow, and every node's returned indices
and values of a sample of reduces, drawn from the seed by reservoir
sampling over the window, against the plain union sum of the same inputs
(``reference/union.py``).  The values are multiples of 2 ** scale_log2
whose sums stay exact in float32, so the comparison is exact.
"""
from __future__ import annotations

import random
import sys
import time

import torch

from portbench import generate, roofline
from portbench.reference import union as ref


class Cell:
    unit = "reduce"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log=sys.stderr):
        from repro_torch.core.api import SparseAllreduce
        self.device = torch.device(device)
        self.m = int(config["nodes"])
        self.out_cap = int(config["vertices"])
        self.limits = traffic["limits"]
        self.work = {"reduces": 1}
        t0 = time.perf_counter()
        gen = generate.generator(seed, self.device, stream=2)
        mult, xor = generate.hash_keys(gen)
        cdf = generate.rank_cdf(int(config["vertices"]),
                                float(config["alpha"]), self.device)
        shape = (self.m, 2 * int(traffic["edges_per_node"]))
        self.pool = []
        for _ in range(int(traffic["pool"])):
            ranks = generate.draw_ranks(cdf, shape[0] * shape[1], gen) \
                .reshape(shape)
            vals = generate.dyadic_values(shape, int(traffic["value_levels"]),
                                          int(traffic["value_scale_log2"]), gen)
            self.pool.append(generate.hashed_layout(
                ranks, vals, int(traffic["capacity"]), mult, xor))
            del ranks, vals
        del cdf
        self.ar = SparseAllreduce(
            self.m, tuple(config["degrees"]), backend="device",
            merge=config["merge"], wire=config["wire"],
            replication=int(config["replication"]), device=self.device,
            seed=int(config["plan_seed"]), plan_cache=False)
        print(f"minibatch set-up: pool {time.perf_counter() - t0:.3f} s",
              file=log)
        self.rng = random.Random(int(seed))
        self.keep = int(traffic["sample_reduces"])
        self.sample = []
        self.overflow = []

    def _reduce(self, i: int):
        idx, val = self.pool[i % len(self.pool)]
        return self.ar.union_reduce(idx, val, self.out_cap)

    def warm(self) -> None:
        """The one shape every batch has: the plan, its transport and every
        kernel's first launch, twice."""
        for i in range(2):
            self._reduce(i)

    def step(self, i: int) -> None:
        oi, ov, ovf = self._reduce(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.overflow.append(ovf)
        if len(self.sample) < self.keep:
            self.sample.append((i, oi, ov))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.sample[j] = (i, oi, ov)

    def facts(self) -> dict:
        """A reduce's least bytes, the mean over the pool (the batches
        cycle)."""
        total = 0
        for idx, _ in self.pool:
            valid = idx != generate.SENTINEL
            union = int(torch.unique(idx[valid]).numel())
            total += roofline.union_reduce_bytes(int(valid.sum()), union,
                                                 self.m)
        return {"reduce_bytes": total / len(self.pool)}

    def check(self) -> dict:
        """Free the program's plan, then hold the sampled reduces to the
        plain union sum of their batches."""
        del self.ar
        overflow = int(torch.stack(self.overflow).sum()) if self.overflow \
            else 0
        lim = self.limits
        worst = {"idx_mismatch": 0, "val_abs_err": 0.0}
        bad = 0
        for i, oi, ov in self.sample:
            idx, val = self.pool[i % len(self.pool)]
            want_i, want_v = ref.union_sum(idx, val)
            got = ref.compare(oi, ov, want_i, want_v)
            bad += any(got[k] > lim[k] for k in got)
            for k in got:
                worst[k] = max(worst[k], got[k])
        checks = [{"name": "overflow", "value": overflow,
                   "limit": lim["overflow"], "ok": overflow <= lim["overflow"]}]
        checks += [{"name": k, "value": v, "limit": lim[k],
                    "ok": bool(self.sample) and v <= lim[k]}
                   for k, v in worst.items()]
        return {"checks": checks, "failed": int(bad)}

    def control(self, dtype=torch.bfloat16) -> dict:
        """The compared numbers with the reference's sums in ``dtype`` put
        in the program's place, for the pool's first batch."""
        idx, val = self.pool[0]
        want_i, want_v = ref.union_sum(idx, val)
        _, low_v = ref.union_sum(idx, val, dtype=dtype)
        n = want_i.numel()
        oi = torch.full((self.m, self.out_cap), generate.SENTINEL,
                        dtype=torch.int64, device=self.device)
        ov = torch.zeros((self.m, self.out_cap), dtype=torch.float32,
                         device=self.device)
        oi[:, :n] = want_i[: self.out_cap]
        ov[:, :n] = low_v[: self.out_cap].to(torch.float32)
        return ref.compare(oi, ov, want_i, want_v)
