"""Training steps of a DeepSeek-V3 decoder (latent attention, shared
experts, sigmoid routing with a held correction bias, leading dense
layers) on the port's training stack, one expert-parallel rank's share of
the experts, with the gradient sync of Sparse Allreduce over the stacked
data positions.

As ``runners/train.py`` (its window, stages, readings and check), with
the configuration's ``DeepSeekV3Config`` (raising at once on a program
that has none), the benchmark's own tree of the model (:func:`tree`),
the correction bias drawn from the seed (a buffer of the configuration,
not a parameter), ``reference/moonlight.py`` in the reference's place and
the FLOP count of ``roofline_mla``.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Tuple

import torch

from portbench import generate, roofline_mla, weights
from portbench.reference import moonlight as ref
from portbench.runners import train

Path = Tuple[str, ...]
MLA = ("wq", "wkv_a", "kv_ln", "wkv_b", "wo")
GAINS = ("ln1", "ln2", "final_ln", "kv_ln")


def tree(cfg: dict) -> Dict[Path, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{path: (shape, dtype)}`` of the model from the configuration's
    published keys: the embedding and the untied head, the leading dense
    layers (``lead``, stacked over ``first_k_dense_replace``) and the MoE
    layers (``blocks``, stacked over the rest), each with a latent
    attention block (``wq``, ``wkv_a``, the latent's norm gain ``kv_ln``,
    ``wkv_b``, ``wo``) and norm gains; the leading layers a SwiGLU of
    ``intermediate_size``, the MoE layers the shared experts' SwiGLU
    (``ffn``, ``n_shared_experts`` x ``moe_intermediate_size`` wide), the
    float32 router over ``published_n_routed_experts`` and the
    ``n_routed_experts`` held experts."""
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    nope, rp = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
    rank, vd = int(cfg["kv_lora_rank"]), int(cfg["v_head_dim"])
    lead = int(cfg["first_k_dense_replace"])
    n = int(cfg["num_hidden_layers"]) - lead
    ff, eff = int(cfg["intermediate_size"]), int(cfg["moe_intermediate_size"])
    sff = int(cfg["n_shared_experts"]) * eff
    held, e = int(cfg["n_routed_experts"]), \
        int(cfg["published_n_routed_experts"])
    vp = weights.padded_vocab(cfg)
    dt, f32 = weights.DTYPES[cfg["torch_dtype"]], torch.float32

    def layer(k: int, width: int) -> dict:
        return {("ln1",): ((k, d), f32), ("ln2",): ((k, d), f32),
                ("mla", "wq"): ((k, d, h * (nope + rp)), dt),
                ("mla", "wkv_a"): ((k, d, rank + rp), dt),
                ("mla", "kv_ln"): ((k, rank), f32),
                ("mla", "wkv_b"): ((k, rank, h * (nope + vd)), dt),
                ("mla", "wo"): ((k, h * vd, d), dt),
                ("ffn", "w1"): ((k, d, width), dt),
                ("ffn", "w3"): ((k, d, width), dt),
                ("ffn", "w2"): ((k, width, d), dt)}

    out = {("emb",): ((vp, d), dt), ("head",): ((d, vp), dt),
           ("final_ln",): ((d,), f32)}
    out.update({("lead", "b0") + p: v for p, v in layer(lead, ff).items()})
    blocks = layer(n, sff)
    blocks.update({("moe", "router"): ((n, d, e), f32),
                   ("moe", "w1"): ((n, held, d, eff), dt),
                   ("moe", "w3"): ((n, held, d, eff), dt),
                   ("moe", "w2"): ((n, held, eff, d), dt)})
    out.update({("blocks", "b0") + p: v for p, v in blocks.items()})
    return out


def leaf(path: Path, shape, dtype, seed: int, device) -> torch.Tensor:
    """``weights.leaf``'s draw, the latent's norm gain a zero gain too."""
    if path[-1] in GAINS:
        return torch.zeros(shape, dtype=dtype, device=device)
    return weights.leaf(path, shape, dtype, seed, device)


def router_bias(cfg: dict, seed: int, device) -> torch.Tensor:
    """The held correction bias, float32 [MoE layers, router experts],
    normal with the configuration's ``router_bias_std``."""
    n = int(cfg["num_hidden_layers"]) - int(cfg["first_k_dense_replace"])
    gen = generate.generator(seed, device, stream=7)
    return torch.randn((n, int(cfg["published_n_routed_experts"])),
                       generator=gen, dtype=torch.float32, device=device) \
        * float(cfg["router_bias_std"])


def port_config(cfg: dict, bias: torch.Tensor):
    """The program's ``DeepSeekV3Config`` of the configuration file;
    raises ``ImportError`` on a program without one."""
    from repro_torch.models.common import DeepSeekV3Config
    d = int(cfg["hidden_size"])
    return DeepSeekV3Config(
        name=cfg["name"], family="moe",
        n_layers=int(cfg["num_hidden_layers"]), d_model=d,
        n_heads=int(cfg["num_attention_heads"]),
        n_kv=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["n_shared_experts"]) * int(cfg["moe_intermediate_size"]),
        vocab=int(cfg["vocab_size"]), pattern=("mla",),
        ffn_pattern=("moe+dense",),
        n_experts=int(cfg["published_n_routed_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        expert_d_ff=int(cfg["moe_intermediate_size"]),
        rope_theta=float(cfg["rope_theta"]), act=cfg["hidden_act"],
        norm_eps=float(cfg["rms_norm_eps"]),
        moe_capacity=float(cfg["moe_capacity_factor"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=weights.DTYPES[cfg["torch_dtype"]],
        q_nope_dim=int(cfg["qk_nope_head_dim"]),
        q_rope_dim=int(cfg["qk_rope_head_dim"]),
        kv_rank=int(cfg["kv_lora_rank"]), v_dim=int(cfg["v_head_dim"]),
        lead_dense=int(cfg["first_k_dense_replace"]),
        lead_d_ff=int(cfg["intermediate_size"]),
        router_scale=float(cfg["routed_scaling_factor"]),
        router_bias=tuple(bias.reshape(-1).tolist()),
        expert_first=int(cfg["held_experts_first"]),
        experts_held=int(cfg["n_routed_experts"]),
        aux_alpha=float(cfg["seq_aux_alpha"]))


class Cell(train.Cell):
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
        self.bias = router_bias(config, seed, self.device)
        cfg = port_config(config, self.bias)
        self.tree = tree(config)
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
            aux_weight=float(config["seq_aux_alpha"]),
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
        return leaf(path, shape, dtype, self.seed, self.device)

    def facts(self) -> dict:
        return {"flops_per_step": roofline_mla.train_step_flops(
            self.config, self.work["tokens"], self.seq)}

    def reference(self, lowp=None, fault=None) -> dict:
        """The reference's readings over the checked steps' batches."""
        batches = [(b["tokens"].reshape(self.m, -1, self.seq),
                    b["labels"].reshape(self.m, -1, self.seq))
                   for b in self.batches[: self.checked]]
        return ref.steps(self.config, self.opt_args, self._leaf,
                         sorted(self.tree), batches, bias=self.bias,
                         lowp=lowp, fault=fault)
