"""Each plain reference against a brute-force NumPy answer at a small
size, and the training reference against the port computing in float32
(the same mathematics: the gaps are round-off)."""
import numpy as np
import pytest
import torch

from portbench import generate
from portbench.reference import granite, pagerank, union


def test_pagerank_reference_is_the_dense_power_iteration():
    gen = generate.generator(7, "cpu")
    edges = generate.powerlaw_edges(300, 3000, 2.0, gen)
    n, d, k = 300, 0.85, 7
    outdeg = np.bincount(edges[:, 0].numpy(), minlength=n).clip(min=1)
    a = np.zeros((n, n))
    for s, t in edges.tolist():
        a[t, s] += 1.0 / outdeg[s]
    p = np.full(n, 1.0 / n)
    for _ in range(k):
        p = (1 - d) / n + d * a @ p
    inv = 1.0 / torch.as_tensor(outdeg, dtype=torch.float64)[edges[:, 0]]
    got = pagerank.pagerank(edges[:, 0], edges[:, 1], inv, n, k, d)
    assert np.allclose(got.numpy(), p, rtol=1e-12, atol=0)
    low = pagerank.pagerank(edges[:, 0], edges[:, 1], inv, n, k, d,
                            dtype=torch.bfloat16)
    assert 1e-4 < pagerank.max_rel_err(low, got) < 0.1


def test_pagerank_assemble_adds_every_nodes_partial_sum():
    out_idx = torch.tensor([0, 2, 2, 3])
    partial = torch.tensor([1.0, 2.0, 3.0, 4.0])
    got = pagerank.assemble(out_idx, partial, 5, 0.5).numpy()
    assert np.allclose(got, 0.1 + 0.5 * np.array([1.0, 0.0, 5.0, 4.0, 0.0]))


def test_union_reference_is_the_dict_sum():
    idx = torch.tensor([[5, 9, generate.SENTINEL], [1, 9, 12]])
    val = torch.tensor([[0.5, 0.25, 7.0], [1.0, 1.0, -2.0]])
    ids, sums = union.union_sum(idx, val)
    assert ids.tolist() == [1, 5, 9, 12]
    assert sums.tolist() == [1.0, 0.5, 1.25, -2.0]
    s = generate.SENTINEL
    good = torch.tensor([[1, 5, 9, 12, s], [1, 5, 9, 12, s]])
    vals = torch.tensor([[1.0, 0.5, 1.25, -2.0, 0.0]] * 2)
    assert union.compare(good, vals, ids, sums) == \
        {"idx_mismatch": 0, "val_abs_err": 0.0}
    bad = good.clone()
    bad[1, 2] = 8
    vals[0, 3] = -1.5
    assert union.compare(bad, vals, ids, sums) == \
        {"idx_mismatch": 1, "val_abs_err": 0.5}
    short = torch.tensor([[1, 5, 9], [1, 5, 9]])
    assert union.compare(short, vals[:, :3], ids, sums)["idx_mismatch"] == 2


def test_moe_capacity_and_drops_by_hand():
    cfg = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
           "num_hidden_layers": 1, "num_local_experts": 40,
           "num_experts_per_tok": 8, "rope_theta": 1e4, "rms_norm_eps": 1e-6,
           "router_aux_loss_coef": 0.01, "moe_capacity_factor": 2.0,
           "expert_capacity_slack": 1.25}
    m = granite.Model(cfg)
    # 4,096 tokens x 8 copies x 2.0 = 65,536 slots; ceil(65,536 / 40) =
    # 1,639; x 1.25 = 2,048.75 -> 2,048
    assert m.capacity(4096) == 2048
    assert m.capacity(1) == 8
    cfg.update(num_local_experts=2, num_experts_per_tok=1,
               moe_capacity_factor=1.0, expert_capacity_slack=1.0)
    m = granite.Model(cfg)
    assert m.capacity(16) == 8
    x = torch.randn(1, 16, 8, dtype=torch.float64).float()
    router = torch.zeros(8, 2)
    router[0, 0] = 100.0            # every token to expert 0 where x[0] > 0
    x[..., 0] = 1.0                 # all of them: 16 copies, 8 kept
    w = [torch.eye(8).expand(2, 8, 8)] * 3
    y, _ = m.moe(x, router, *w)
    expect = torch.nn.functional.silu(x[0]) * x[0]
    assert torch.allclose(y[0, :8], expect[:8], atol=1e-6)
    assert bool((y[0, 8:] == 0).all())


def test_worst_gap_and_kept_leaves():
    want = {("a",): 1.0, ("b",): 2.0, ("c",): 1e-9}
    got = {("a",): 1.1, ("b",): 2.0, ("c",): 5.0}
    kept = granite.kept_leaves(want, 1e-3)
    assert kept == [("a",), ("b",)]
    # |1.1 - 1| over max(1, median 2) = 0.05
    assert granite.worst_gap(got, want, kept) == pytest.approx(0.05)


def test_training_reference_equals_the_port_in_float32(small):
    """The port's step at float32 and the reference from the same
    weights and batches: their gaps are round-off, so the reference
    computes what the port's model, MoE, sync and AdamW compute."""
    from portbench import control
    ov = small("train.granite-moe-3b")
    ov["config"] = dict(ov["config"], torch_dtype="float32")
    got = control.readings("train.granite-moe-3b", 2**33 + 1, 0.2, "cpu",
                           overrides=ov, with_control=False)
    for k in ("grad_gap", "change_gap"):
        assert got["program"][k] < 1e-5, (k, got["program"])
    d = got["detail"]
    assert abs(d["program_losses"][0] - d["reference_losses"][0]) < 1e-5, d
