"""The yardstick's byte and FLOP counts against hand-worked values, and
the trace reduction on a hand-made trace."""
import pytest

from portbench import roofline, tracing


def test_byte_counts_by_hand():
    # 10 nonzeros x (4 + 4) + 5 row starts x 4 + 6 x 4 read + 4 x 4 written
    assert roofline.csr_product_bytes(10, 4, 6, 4) == 80 + 20 + 24 + 16
    # the CSR and the rank vector of 6 read and written
    assert roofline.pagerank_round_bytes(10, 4, 6) == 80 + 20 + 48
    # 100 entries in, 4 nodes x 50 out, 12 bytes an entry (int64 + f32)
    assert roofline.union_reduce_bytes(100, 50, 4) == 1200 + 2400
    assert roofline.union_reduce_bytes(100, 50, 4, value_width=2) == \
        1600 + 3200
    assert roofline.hbm_ms(3.35e9) == pytest.approx(1.0)


def test_train_step_flops_by_hand():
    cfg = {"hidden_size": 1536, "num_attention_heads": 24,
           "num_key_value_heads": 8, "num_hidden_layers": 32,
           "num_experts_per_tok": 8, "intermediate_size": 512,
           "num_local_experts": 40, "vocab_size": 49155}
    # attention 1536 x 64 x (24 + 24 + 8 + 8) = 6,291,456; experts
    # 8 x 3 x 1536 x 512 = 18,874,368, router 1536 x 40 = 61,440; 32
    # layers = 807,272,448; head 1536 x 49,155 = 75,502,080
    active = 32 * (6_291_456 + 18_874_368 + 61_440) + 75_502_080
    assert active == 882_774_528
    # scores and values, 2 x 2 x T x hd a head and token forward, half
    # under the mask, x 3 with the backward: 32 x 24 x 393,216 per token
    ctx = 32 * 24 * 4 * 2048 * 64 * 0.5 * 3
    assert roofline.train_step_flops(cfg, 8192, 2048) == \
        pytest.approx((6 * active + ctx) * 8192, rel=1e-12)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_reduce_trace_busy_ops_and_gaps():
    events = [
        _ev(tracing.WINDOW_SPAN, "user_annotation", 100, 100),
        _ev("portbench.job", "user_annotation", 100, 100),
        _ev("aten::copy_", "cpu_op", 150, 20),
        _ev("void a::spmv_csr_kernel<int>(int const*)", "kernel", 110, 20),
        _ev("run_sum(int const*, int)", "kernel", 120, 20),
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 160, 5),
        _ev("late", "kernel", 195, 10),           # ends after the window
    ]
    tr = tracing.reduce_trace(events)
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["busy_s"] == pytest.approx(35e-6)      # [110, 140] + [160, 165]
    assert tr["device_ops"][0][1] == pytest.approx(20e-6)
    gaps = dict((round(s * 1e6), n) for n, s in tr["idle_gaps"])
    assert gaps == {10: "portbench.job -> aten::copy_",
                    20: "portbench.job -> aten::copy_",
                    35: "aten::copy_ -> end"}
    assert tracing.device_us(tr, ("spmv_csr_kernel",)) == (20.0, 1)
    assert tracing.device_us(tr, ("spmv_csr_kernel",), exclude=True) == \
        (25.0, 2)
    assert tracing.device_us(tr, ("run_sum", "tile_hist")) == (20.0, 1)
    assert tracing.device_us(tr, ("sum",)) == (0.0, 0)
    assert tracing.reduce_trace([])["busy_s"] == 0.0


def test_reduce_trace_of_device_activity_alone():
    """A CUDA-only trace has no window span: the window is the extent of
    its events, and the host is its runtime calls."""
    events = [
        _ev("cudaGraphLaunch", "cuda_runtime", 0, 10),
        _ev("k1", "kernel", 8, 50),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 12, 48),
        _ev("cudaMemcpyAsync", "cuda_runtime", 70, 5),
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 74, 6),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 76, 6),
    ]
    tr = tracing.reduce_trace(events)
    assert tr["window_s"] == pytest.approx(82e-6)
    assert tr["busy_s"] == pytest.approx(56e-6)
    gaps = dict((round(s * 1e6), n) for n, s in tr["idle_gaps"])
    assert gaps == {8: "cudaGraphLaunch -> cudaDeviceSynchronize",
                    16: "cudaDeviceSynchronize -> cudaMemcpyAsync",
                    2: "cudaDeviceSynchronize -> end"}
