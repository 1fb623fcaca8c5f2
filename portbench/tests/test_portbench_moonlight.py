"""The Moonlight training cell (``train-4k.moonlight-16b-a3b``) on the
CPU at a small size: the sound run is correct and each planted fault of
``test_portbench_faults`` is not; the program's parameter tree at the
published widths is the benchmark's; the cell raises at once on a
program without the configuration; the readers of the models' spans on
a hand-built timeline; the FLOP count against the published
reckoning."""
import pytest
import torch

from portbench import harness, roofline_mla, spans
from portbench.runners import train_mla
from test_portbench_faults import FAULTS, plant
from test_portbench_spans import _Span, _fake_obs

CELL = "train-4k.moonlight-16b-a3b"
# float32: the port's gaps to the float32 reference are then round-off,
# under the cell's own limits; 4 of 16 experts held, from expert 4
SMALL = {"config": {"hidden_size": 64, "num_attention_heads": 4,
                    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                    "kv_lora_rank": 32, "v_head_dim": 16,
                    "num_hidden_layers": 3, "intermediate_size": 96,
                    "moe_intermediate_size": 24, "n_routed_experts": 4,
                    "published_n_routed_experts": 16,
                    "held_experts_first": 4, "num_experts_per_tok": 4,
                    "vocab_size": 512, "torch_dtype": "float32"},
         "traffic": {"seq": 32, "rows_per_position": 2, "batches": 8,
                     "trace_units": 1}}


def _config(**over):
    b = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    config = harness.cell_spec(b, CELL)[1]
    config.update(over)
    return config


def test_the_sound_run_is_correct():
    line = harness.run_cell(CELL, 2**31 + 101, 0.2, False, device="cpu",
                            overrides=SMALL)
    assert line["correct"], line["checks"]
    assert {"train_tokens_per_s", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    plant(monkeypatch, CELL, fault)
    line = harness.run_cell(CELL, 2**31 + 101, 0.2, False, device="cpu",
                            overrides=SMALL)
    assert not line["correct"], line["checks"]


def test_the_programs_tree_at_published_widths_is_the_benchmarks():
    """Paths, shapes and dtypes: the lead layer, 26 MoE layers of 8 held
    experts, the router's 64 outputs, the whole untied vocabulary."""
    from repro_torch.models import transformer as T
    config = _config()
    bias = train_mla.router_bias(config, 5, "cpu")
    cfg = train_mla.port_config(config, bias)
    got = {p: (tuple(t.shape), t.dtype) for p, t in T.tree_leaves(
        T.init_params(cfg, 1, device="meta"))}
    want = train_mla.tree(config)
    assert got == want
    assert want[("blocks", "b0", "moe", "w1")][0] == (26, 8, 2048, 1408)
    assert want[("blocks", "b0", "moe", "router")][0] == (26, 2048, 64)
    assert want[("emb",)][0] == (163840, 2048)
    assert sum(torch.Size(s).numel() for s, _ in want.values()) \
        == cfg.param_count()


def test_a_program_without_the_configuration_raises_at_once(monkeypatch):
    import repro_torch.models.common as C
    monkeypatch.delattr(C, "DeepSeekV3Config")
    with pytest.raises(ImportError):
        train_mla.Cell(_config(**SMALL["config"]),
                       dict(harness.load_json(
                           f"{harness.ROOT}/portbench/traffic/train-4k.json"),
                           **SMALL["traffic"]), 1, "cpu")


def test_model_span_readers(monkeypatch):
    """Two steps: ``model.mla`` spans of 3 + 4 and 5 ms, ``model.moe`` of
    2 and 1 + 1 ms (one nested in a sync span: still the step's); a span
    outside every step is not counted."""
    tl = [_Span(1, None, "train.step"),
          _Span(2, 1, "model.mla", 0.0, 3.0, root=1),
          _Span(3, 1, "model.mla", 3.0, 7.0, root=1),
          _Span(4, 1, "model.moe", 7.0, 9.0, root=1),
          _Span(10, None, "train.step"),
          _Span(11, 10, "model.mla", 0.0, 5.0, root=10),
          _Span(12, 10, "model.moe", 5.0, 6.0, root=10),
          _Span(13, 10, "train.sync.sparse", 6.0, 7.0, root=10),
          _Span(14, 13, "model.moe", 6.0, 7.0, root=10),
          _Span(20, None, "model.mla", 0.0, 99.0)]
    _fake_obs(monkeypatch, tl)
    assert harness.reader("train.mla_ms")({}) == pytest.approx(6.0)
    assert harness.reader("train.moe_ms")({}) == pytest.approx(2.0)
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert harness.reader("train.mla_ms")({}) is None
    assert harness.reader("train.moe_ms")({}) is None


def test_flops_per_token_as_reckoned():
    """10,088 model MFLOP a token at 4,096 positions: MLA 39 %, the shared
    experts 27 %, layer 0's FFN 4 %, the held routed experts 10 %, the
    head 20 % (products and context, forward and backward)."""
    config = _config()
    per_token = roofline_mla.train_step_flops(config, 8192, 4096) / 8192
    assert per_token == pytest.approx(10.088e9, rel=1e-3)
    head = 6 * 2048 * 163840
    assert head / per_token == pytest.approx(0.20, abs=0.005)
