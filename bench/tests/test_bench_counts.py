"""The yardstick against hand-worked cases, and the trace's reduction on a
hand-made profiler trace."""
from __future__ import annotations

import pathlib
import statistics
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import trace, yardstick  # noqa: E402

LAYER = {"c_in": 2, "h_in": 4, "w_in": 5, "n_kernels": 3, "h_k": 3,
         "w_k": 3}


def test_conv_counts_by_hand():
    # output 2 x 3; each value 2*3*3 = 18 MACs; 3 channels: 3*6*18 = 324
    assert yardstick.conv_out_hw(LAYER) == (2, 3)
    assert yardstick.conv_macs(LAYER) == 324
    assert yardstick.conv_flops(LAYER) == 648
    # input 40, kernels 54, output 18 elements, once each, 4 bytes
    assert yardstick.conv_bytes(LAYER, "float32") == (40 + 54 + 18) * 4
    assert yardstick.conv_bytes(LAYER, "bfloat16") == (40 + 54 + 18) * 2
    strided = dict(LAYER, s_h=2, s_w=2)
    assert yardstick.conv_out_hw(strided) == (1, 2)


def test_least_time_is_the_larger_bound():
    assert yardstick.least_seconds(67e12, 0, "float32") == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 3.35e12, "float32") == \
        pytest.approx(1.0)
    assert yardstick.least_seconds(67e12, 6.7e12, "float32") == \
        pytest.approx(2.0)
    both = yardstick.conv_pass_least_seconds([LAYER, LAYER], "float32")
    assert both == pytest.approx(2 * (112 * 4) / 3.35e12)


def test_k5_counts_by_hand():
    # 2 sequences, 2 KV heads, 5 rows, D 4, bf16: K and V 2*2*2*5*4*2 =
    # 320 bytes; q and out 2 * (2 * 4 heads * 4) * 2 = 128 bytes
    assert yardstick.k5_bytes(2, 4, 2, 4, 5) == 320 + 128
    # QK^T and PV: 4 * 2 * 4 * 5 * 4
    assert yardstick.k5_flops(2, 4, 4, 5) == 640


def test_model_flops_by_hand_and_as_the_program_counts():
    m = {"hidden_size": 8, "intermediate_size": 16,
         "num_hidden_layers": 2, "num_attention_heads": 2,
         "num_key_value_heads": 1, "vocab_size": 32}
    # per layer: q 64, k 32, v 32, o 64, ffn 3*8*16 = 384; head 256
    assert yardstick.dense_matmul_params_per_token(m) == 2 * 576 + 256
    assert yardstick.decode_step_flops(m, 3, 10) == \
        3 * (2 * 1408 + 2 * 4 * 10 * 2 * 4)
    from repro_torch.launch import model_flops
    from repro_torch.models.registry import get
    cfg = get("qwen2-7b").cfg
    qwen = {"hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "vocab_size": cfg.padded_vocab}
    assert 2 * yardstick.dense_matmul_params_per_token(qwen) == \
        model_flops.active_param_flops_per_token(cfg)


def test_percentile_and_spread():
    values = list(range(1, 101))
    assert yardstick.p95(values) == pytest.approx(
        statistics.quantiles(values, n=20, method="inclusive")[18])
    q1, q2, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert yardstick.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == \
        pytest.approx((q3 - q1) / q2)


def _events():
    def ev(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}
    k1 = "void (anonymous namespace)::conv2d_offload_planned_kernel<float>" \
        "(float const*, int)"
    return [
        ev("cuda_runtime", "cudaLaunchKernelExC", 0, 5, 1),
        ev("kernel", k1, 10, 20, 1),
        ev("cuda_runtime", "cudaLaunchKernelExC", 40, 5, 2),
        ev("kernel", k1, 50, 20, 2),
        ev("cuda_runtime", "cudaDeviceSynchronize", 65, 30, 3),
        ev("cuda_runtime", "cudaLaunchKernel", 75, 2, 4),
        ev("kernel", "void at::native::elementwise_kernel<4>(int)", 80, 10,
           4),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 99},
    ]


def test_trace_reduction_on_a_hand_made_trace():
    t = trace.DeviceTrace(_events(), window_s=100e-6)
    assert trace.short(t.device[0][0]) == "conv2d_offload_planned_kernel"
    assert t.busy_s() == pytest.approx(50e-6)
    assert t.device_seconds() == pytest.approx(50e-6)
    assert t.kernel_seconds("conv2d_offload_planned_kernel") == \
        pytest.approx(40e-6)
    # one of four launches dropped: the mean of those seen times four
    assert t.kernel_seconds("conv2d_offload_planned_kernel",
                            launches=4) == pytest.approx(80e-6)
    assert t.kernel_seconds("flash_decode") is None
    assert t.top_ops()[0] == ["conv2d_offload_planned_kernel",
                              pytest.approx(40e-6)]
    gaps = dict(t.idle_gaps())
    # 30-50: the host had not reached the second launch; 70-80: it sat in
    # a synchronisation
    assert gaps["host before cudaLaunchKernelExC of "
                "conv2d_offload_planned_kernel"] == pytest.approx(20e-6)
    assert gaps["host in cudaDeviceSynchronize"] == pytest.approx(10e-6)
