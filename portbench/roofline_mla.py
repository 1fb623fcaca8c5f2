"""Model FLOPs of a training step of a DeepSeek-V3 decoder (latent
attention, shared and routed experts, leading dense layers), counted from
the configuration's published keys, never from what the program reports.
The peaks and the rules of counting are ``roofline``'s."""
from __future__ import annotations


def train_step_flops(cfg: dict, tokens: int, seq: int) -> float:
    """6 x the matmul parameters a token uses x tokens, plus attention's
    two products (scores over nope + rope columns, values over
    ``v_head_dim``) forward and backward under a causal mask, with no
    recompute.  A token uses every leading layer, and in each MoE layer
    the latent attention, the shared experts, the router and the routed
    experts held here: ``num_experts_per_tok`` of
    ``published_n_routed_experts`` routes, ``n_routed_experts`` of whose
    experts this card holds.  The head is a matmul; the embedding lookup
    is not."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rank, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
    lead = cfg["first_k_dense_replace"]
    layers = cfg["num_hidden_layers"]
    mla = d * h * (nope + rope) + d * (rank + rope) \
        + rank * h * (nope + vd) + h * vd * d
    swiglu = 3 * d
    shared = swiglu * cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    routed = swiglu * cfg["moe_intermediate_size"] \
        * cfg["num_experts_per_tok"] * cfg["n_routed_experts"] \
        / cfg["published_n_routed_experts"]
    router = d * cfg["published_n_routed_experts"]
    active = lead * (mla + swiglu * cfg["intermediate_size"]) \
        + (layers - lead) * (mla + shared + routed + router) \
        + d * cfg["vocab_size"]
    # scores (nope + rope wide) and values (v wide): 2 * T * width a head
    # forward, half under the causal mask, x 3 with the backward
    attn_ctx = layers * h * 2 * seq * (nope + rope + vd) * 0.5 * 3 * tokens
    return 6.0 * active * tokens + attn_ctx
