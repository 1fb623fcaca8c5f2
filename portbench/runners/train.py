"""Training steps of a MoE decoder on the port's training stack, with the
gradient sync of Sparse Allreduce over the stacked data positions.

Set-up builds the configuration's ``ModelConfig`` and the step of
``make_train_step`` (its sync, merge and wire, AdamW), checks that the
program's parameter tree is the one the benchmark draws
(``weights.decoder_tree``), draws the weights on the device from the
seed and a pool of Zipf token batches, and drives the step through its
first ``checked_steps`` steps: its mean losses, each leaf's norm of the
first gradient as AdamW got it (read back from the first moment after
step 1) and each leaf's norm of its change over those steps are the
program's readings.  The same step and state then run the window, one
step a unit on the next batch, each ending in a synchronisation.  With
``--trace 1`` the traced steps record CUDA events at the step's ``mark``
hooks (forward + backward, sync, update).

The check: the window's losses finite and its sync never overflowing,
and the readings against ``reference/granite.py``'s float32 steps from
the same weights and batches: the worst leaf's gap of each norm over the
larger of the reference leaf's norm and the median leaf's, over the
leaves whose reference gradient is not round-off (``kept_share`` of the
median leaf's).  The first step's loss gap is read and printed; it is
compared only where the traffic gives it a limit.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from portbench import generate, roofline, weights
from portbench.reference import granite as ref


def as_run(cfg: dict, key: str):
    """The value the benchmark runs for ``key``: the configuration's
    ``assumed`` value where the port departs from the published one."""
    note = cfg.get("assumed", {}).get(key)
    return note["value"] if isinstance(note, dict) else cfg[key]


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of the configuration file."""
    from repro_torch.models.common import ModelConfig
    d = int(cfg["hidden_size"])
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=int(cfg["num_hidden_layers"]),
        d_model=d, n_heads=int(cfg["num_attention_heads"]),
        n_kv=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["intermediate_size"]), vocab=int(cfg["vocab_size"]),
        head_dim=d // int(cfg["num_attention_heads"]),
        pattern=("attn",), ffn_pattern=("moe",),
        n_experts=int(cfg["num_local_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        expert_d_ff=int(cfg["intermediate_size"]),
        rope_theta=float(cfg["rope_theta"]), act=cfg["hidden_act"],
        norm_eps=float(cfg["rms_norm_eps"]),
        moe_capacity=float(cfg["moe_capacity_factor"]),
        tie_embeddings=bool(as_run(cfg, "tie_word_embeddings")),
        dtype=weights.DTYPES[cfg["torch_dtype"]])


class Cell:
    unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 log=sys.stderr):
        from repro_torch.models import transformer as T
        from repro_torch.optim.adamw import AdamW
        from repro_torch.train.step import make_train_step, mesh_ctx
        self.device = torch.device(device)
        self.log = log
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.limits = traffic["limits"]
        m, rows, seq = (int(config["data_positions"]),
                        int(traffic["rows_per_position"]), int(traffic["seq"]))
        self.m, self.seq = m, seq
        self.work = {"tokens": m * rows * seq}
        t0 = time.perf_counter()
        cfg = port_config(config)
        self.tree = weights.decoder_tree(config)
        meta = {p: (tuple(t.shape), t.dtype) for p, t in T.tree_leaves(
            T.init_params(cfg, 1, device="meta"))}
        if meta != self.tree:
            raise ValueError(f"the program's parameter tree is not the "
                             f"benchmark's: {sorted(set(meta.items()) ^ set(self.tree.items()))}")
        self.opt_args = config["optimizer"]
        opt = AdamW(**self.opt_args)
        self.step_fn, _ = make_train_step(
            cfg, mesh_ctx(m, device=self.device), sync=config["sync"],
            opt=opt, dp_degrees={"data": tuple(config["dp_degrees"])},
            aux_weight=float(config["router_aux_loss_coef"]),
            sparse_tokens_hint=rows * seq, sync_merge=config["sync_merge"],
            sync_wire=config["sync_wire"])
        gen = generate.generator(seed, self.device, stream=3)
        toks = generate.zipf_tokens(
            (int(traffic["batches"]), m * rows, seq + 1),
            int(config["vocab_size"]), float(traffic["alpha"]), gen)
        self.batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]}
                        for t in toks.unbind(0)]
        params = weights.nest({p: self._leaf(p) for p in self.tree})
        st = opt.init(params)
        t1 = time.perf_counter()
        self.readings = {"losses": []}
        self.checked = int(traffic["checked_steps"])
        for j in range(self.checked):
            params, st, mets = self.step_fn(params, st, self.batches[j])
            self.readings["losses"].append(float(mets["loss"]))
            if j == 0:
                self.readings["grad_norms"] = {
                    p: float(torch.linalg.vector_norm(
                        t.to(torch.float32) / (1 - opt.b1)))
                    for p, t in T.tree_leaves(st.m)}
        self.readings["change_norms"] = {
            p: float(torch.linalg.vector_norm(
                t.to(torch.float32) - self._leaf(p).to(torch.float32)))
            for p, t in T.tree_leaves(params)}
        self.params, self.st = params, st
        self.losses, self.overflow, self.events = [], [], []
        print(f"train set-up: build {t1 - t0:.3f} s, {self.checked} checked "
              f"steps {time.perf_counter() - t1:.3f} s, losses "
              f"{self.readings['losses']}", file=log)

    def _leaf(self, path) -> torch.Tensor:
        shape, dtype = self.tree[path]
        return weights.leaf(path, shape, dtype, self.seed, self.device)

    def warm(self) -> None:
        """Nothing left: the checked steps ran every shape of the window."""

    def step(self, i: int) -> None:
        batch = self.batches[(self.checked + i) % len(self.batches)]
        mark = None
        if i < int(self.traffic["trace_units"]) and self.device.type == "cuda":
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ("start", "fwd_bwd", "sync", "update")}
            ev["start"].record()
            mark = lambda k: ev[k].record()  # noqa: E731
            self.events.append(ev)
        self.params, self.st, mets = self.step_fn(self.params, self.st, batch,
                                                  mark=mark)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.losses.append(mets["loss"])
        self.overflow.append(mets["sync_overflow"])

    def facts(self) -> dict:
        c = self.config
        return {"flops_per_step": roofline.train_step_flops(
            c, self.work["tokens"], self.seq)}

    def spans(self, traced: int) -> dict:
        """Milliseconds of each stage of the traced steps."""
        out = {"fwd_bwd_ms": [], "sync_ms": [], "update_ms": []}
        for ev in self.events[:traced]:
            for k, a, z in (("fwd_bwd_ms", "start", "fwd_bwd"),
                            ("sync_ms", "fwd_bwd", "sync"),
                            ("update_ms", "sync", "update")):
                out[k].append(ev[a].elapsed_time(ev[z]))
        return out

    def _free_program(self) -> None:
        del self.params, self.st, self.step_fn
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, lowp=None, fault=None) -> dict:
        """The reference's readings over the checked steps' batches."""
        batches = [(b["tokens"].reshape(self.m, -1, self.seq),
                    b["labels"].reshape(self.m, -1, self.seq))
                   for b in self.batches[: self.checked]]
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return ref.steps(self.config, self.opt_args, self._leaf,
                             sorted(self.tree), batches, lowp=lowp,
                             fault=fault)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow

    def gaps(self, got: dict, want: dict) -> dict:
        """The compared numbers of readings ``got`` against ``want``: the
        first step's loss gap (the losses after an update swing with
        round-off: the first AdamW step moves every element by about lr),
        and the worst kept leaf's gap of the first gradient's norm and of
        the change's norm."""
        kept = ref.kept_leaves(want["grad_norms"],
                               float(self.traffic["kept_share"]))
        return {"loss1_gap": abs(got["losses"][0] - want["losses"][0]),
                "grad_gap": ref.worst_gap(got["grad_norms"],
                                          want["grad_norms"], kept),
                "change_gap": ref.worst_gap(got["change_norms"],
                                            want["change_norms"], kept)}

    def check(self) -> dict:
        self._free_program()
        losses = torch.stack(self.losses) if self.losses else None
        nonfinite = int((~torch.isfinite(losses)).sum()) if losses is not None \
            else 0
        if losses is not None:
            print(f"train window losses: first {float(losses[0]):.4f}, "
                  f"largest {float(losses.max()):.4f}, last "
                  f"{float(losses[-1]):.4f} over {losses.numel()} steps",
                  file=self.log)
        overflow = int(torch.stack(self.overflow).max()) if self.overflow \
            else 0
        self.want = self.reference()
        got = self.gaps(self.readings, self.want)
        lim = self.limits
        checks = [{"name": "nonfinite_losses", "value": nonfinite,
                   "limit": lim["nonfinite_losses"],
                   "ok": nonfinite <= lim["nonfinite_losses"]},
                  {"name": "sync_overflow", "value": overflow,
                   "limit": lim["sync_overflow"],
                   "ok": overflow <= lim["sync_overflow"]}]
        checks += [{"name": k, "value": v, "limit": lim[k], "ok": v <= lim[k]}
                   for k, v in got.items() if k in lim]
        for k in sorted(set(got) - set(lim)):
            print(f"train {k} {got[k]!r} (read, not compared: no limit)",
                  file=self.log)
        return {"checks": checks,
                "failed": int(not all(c["ok"] for c in checks))}

    def detail(self) -> dict:
        """Each checked step's loss on both sides, and the leaves that set
        the norm gaps (after :meth:`check`)."""
        kept = ref.kept_leaves(self.want["grad_norms"],
                               float(self.traffic["kept_share"]))
        return {"program_losses": self.readings["losses"],
                "reference_losses": self.want["losses"],
                "grad_worst": ref.worst_leaf(self.readings["grad_norms"],
                                             self.want["grad_norms"], kept),
                "change_worst": ref.worst_leaf(self.readings["change_norms"],
                                               self.want["change_norms"],
                                               kept)}

    def control(self, lowp=(torch.float8_e4m3fn, torch.float8_e5m2)) -> dict:
        """The compared numbers with the reference in float8 (e4m3 operands,
        e5m2 gradients, per-tensor scales) in the program's place, and
        those of the reference with a fault planted (half the batch, the
        exchange left out); after :meth:`check`."""
        out = {"control": self.gaps(self.reference(lowp=lowp), self.want)}
        for fault in ("half_batch", "no_exchange"):
            out[fault] = self.gaps(self.reference(fault=fault), self.want)
        return out
