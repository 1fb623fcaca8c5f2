"""The yardstick's peaks and the least bytes and operations of the work.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W limit
(dense rates).  Byte counts take each input once and each output once,
whatever the program reads again; operation counts are the model's own,
with no recompute.  Every function counts from what the benchmark made
or from the published configuration, never from what the program
reports.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def hbm_ms(nbytes: float) -> float:
    """Least milliseconds to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def csr_product_bytes(nnz: int, rows: int, x_len: int, y_len: int) -> int:
    """One CSR product y = A x over all nodes: int32 columns and float32
    weights per nonzero, int32 row starts (rows + 1), x read, y written
    (float32)."""
    return nnz * (4 + 4) + (rows + 1) * 4 + x_len * 4 + y_len * 4


def pagerank_round_bytes(nnz: int, rows: int, state_len: int) -> int:
    """One PageRank round: the stacked CSR (columns, weights, row starts)
    and the float32 rank vector read and written once."""
    return nnz * (4 + 4) + (rows + 1) * 4 + 2 * state_len * 4


def union_reduce_bytes(input_entries: int, union_entries: int, nodes: int,
                       value_width: int = 1) -> int:
    """One union reduce: every node's valid input entries read once (int64
    index, float32 values) and the union returned to every node written
    once."""
    entry = 8 + 4 * value_width
    return input_entries * entry + nodes * union_entries * entry


def train_step_flops(cfg: dict, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step of the configuration ``cfg`` (the
    published keys of a MoE decoder): 6 x the active matmul parameters a
    token x tokens, plus attention's two products (scores and values)
    forward and backward under a causal mask, with no recompute.  The
    embedding lookup is no matmul; the output head is."""
    d = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"]
    hd = d // heads
    layers = cfg["num_hidden_layers"]
    attn = d * hd * heads * 2 + d * hd * kv * 2
    moe = cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"] \
        + d * cfg["num_local_experts"]
    head = d * cfg["vocab_size"]
    active = layers * (attn + moe) + head
    # scores and values: 2 * T * T * hd a head forward, half under the
    # causal mask, x 3 with the backward
    attn_ctx = layers * heads * 2 * 2 * seq * hd * 0.5 * 3 * tokens
    return 6.0 * active * tokens + attn_ctx
