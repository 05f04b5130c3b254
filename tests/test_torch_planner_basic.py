"""The cases of ``tests/test_planner_basic.py``, read on ``repro_torch``
with the same inputs and settings. The port's planner plans against the
card it runs on by default; given the reference's chip (``TPU_V5E``) it
prices it as the reference does, so the reference's roofline crossover is
held on that chip, word for word. The H100's own crossover, at the rates
measured on the card, is ``test_h100_roofline_crossover``. The
reference's docstring follows.

Planner tests that need no hypothesis: deterministic pricing checks and
the TPU chip-model translation.
"""
import pytest

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
    crossover = TPU_V5E.peak_flops / TPU_V5E.hbm_bw      # ~240 flops/byte
    # AI >> crossover
    p_big = planner.plan_matmul(8192, 8192, 8192, chip=TPU_V5E)
    assert p_big.duration_overlapped == p_big.flops / TPU_V5E.peak_flops
    # AI << crossover
    p_small = planner.plan_matmul(128, 128, 128, chip=TPU_V5E)
    assert p_small.duration_overlapped > \
        p_small.flops / TPU_V5E.peak_flops


def test_h100_roofline_crossover():
    """The H100's claim, at the rates measured on the card under a GeMM's
    load (``H100_SXM.tensor_flops``, ``smem_fill_bw``, ``l2_bw``; the
    data sheet's ``hbm_bw``): each term's crossover, its rate over its
    bandwidth, against the FLOPs a byte of K3's widest tile, 128 x 256,
    moves through that term (A unicast, B shared by the 2 x 1 cluster's
    two ranks, as the plan runs it).  Where the tile clears the landing
    crossover the 8192^3 plan is compute-bound, as the reference's claim
    says: its duration is its operations term, the product at the tensor
    rate above every byte term, plus the fixed work of K3's steps, which
    the SMs do while the tensor cores idle; where it does not, landing
    exceeds the product by the measured margin.  Either way 128^3 is not
    compute-bound."""
    chip = H100_SXM
    bm, bn, bk = 128, 256, 128
    step = 2 * bm * bn * bk
    per_byte = {"landing": step / (2 * (bm * bk + bk * bn)),
                "l2": step / (2 * (bm * bk + bk * bn // 2)),
                "dram": 2 * 8192 / (3 * 2)}       # A, B and C once
    crossover = {"landing": chip.tensor_flops / chip.smem_fill_bw,
                 "l2": chip.tensor_flops / chip.l2_bw,
                 "dram": chip.tensor_flops / chip.hbm_bw}
    assert per_byte["landing"] == pytest.approx(85.33, abs=0.01)
    p_big = planner.plan_matmul(8192, 8192, 8192)
    tiles = p_big.tiles
    terms = planner.gemm_terms(
        {d: 8192 // tiles["b" + d] for d in "mnk"}, tiles["bm"],
        tiles["bn"], tiles["bk"], p_big.order, p_big.cluster, 2)
    ops = p_big.flops / chip.tensor_flops / terms["share"]  # its waves' SMs
    landing = p_big.hbm_bytes / chip.smem_fill_bw / terms["share"]
    assert terms["tensor"] == ops
    assert terms["operations"] == ops + terms["step"]
    assert p_big.flops / p_big.hbm_bytes <= per_byte["landing"]
    if per_byte["landing"] >= crossover["landing"]:
        assert all(per_byte[x] >= crossover[x] for x in crossover)
        assert p_big.duration_overlapped == terms["operations"]
        assert ops > max(landing, terms["l2"], terms["dram"])
    else:
        assert landing > ops
        assert landing / ops == pytest.approx(
            crossover["landing"] / (p_big.flops / p_big.hbm_bytes))
    p_small = planner.plan_matmul(128, 128, 128)
    assert p_small.duration_overlapped > p_small.flops / chip.tensor_flops
