"""The cases of ``tests/test_planner_basic.py``, read on ``repro_torch``
with the same inputs and settings. The port's planner plans against the
card it runs on, so the roofline crossover is the H100's (``H100_SXM``);
the TPU chip model's translation is the reference's. The reference's
docstring follows.

Planner tests that need no hypothesis: deterministic pricing checks and
the TPU chip-model translation.
"""
from repro_torch.core import planner
from repro_torch.core.cost_model import H100_SXM, TPU_V5E
from _torch_port import fast_polish_port  # noqa: F401


def test_gemm_order_pricing_matches_intuition():
    """For tall-skinny C with huge K, an A-revisiting order beats naive
    re-streaming — the planner must see that (the paper's 'strategy choice
    matters' claim transplanted to GeMM)."""
    # square big matmul: output-stationary should win (C never RMW'd)
    p = planner.plan_matmul(8192, 8192, 8192)
    assert p.order.endswith("k")


def test_tpu_hardware_model_translation():
    hw = TPU_V5E.as_hardware_model(dtype_bytes=2)
    assert hw.nbop_pe == int(197e12 / 2)
    assert abs(hw.t_l - 2 / 819e9) < 1e-18
    assert hw.size_mem == 128 * 1024 * 1024 // 2


def test_chip_model_roofline_crossover():
    """Arithmetic-intensity crossover: ops with AI above peak/bw are
    compute-bound in the planner's overlapped model."""
    crossover = H100_SXM.peak_flops / H100_SXM.hbm_bw      # ~240 flops/byte
    p_big = planner.plan_matmul(8192, 8192, 8192)        # AI >> crossover
    assert p_big.duration_overlapped == p_big.flops / H100_SXM.peak_flops
    p_small = planner.plan_matmul(128, 128, 128)         # AI << crossover
    assert p_small.duration_overlapped > \
        p_small.flops / H100_SXM.peak_flops
