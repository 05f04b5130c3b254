"""The cases of ``tests/test_simulator_basic.py``, read on ``repro_torch``
with the same inputs and settings; the JAX oracle ``reference_conv_jax``
is the port's ``reference_conv_torch``. The reference's docstring
follows.

Simulator (Sec 6) deterministic tests: functional correctness vs
oracles, metric consistency with the formalism, capacity enforcement.
(The any-strategy property test lives in test_simulator.py and needs
hypothesis.)
"""
import numpy as np
import pytest

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import run_steps
from repro_torch.core.strategies import row_by_row, zigzag
from repro_torch.sim import ConvLayer, System
from repro_torch.sim.functional import reference_conv, reference_conv_torch
from repro_torch.sim.trace import render_group_grid, render_input_heatmap
from _torch_port import fast_polish_port  # noqa: F401

HW = HardwareModel(nbop_pe=10**9, size_mem=10**9)


def test_oracles_agree():
    spec = ConvSpec(3, 8, 9, 4, 3, 2, 2, 1)
    layer = ConvLayer.random(spec)
    np.testing.assert_allclose(reference_conv(layer),
                               reference_conv_torch(layer), atol=1e-4)


def test_metrics_match_formalism():
    spec = ConvSpec(2, 6, 6, 2, 3, 3)
    layer = ConvLayer.random(spec)
    strat = zigzag(spec, 3)
    rep = System(layer, HW).run(strat)
    formal = run_steps(strat.to_steps(), spec, HW)
    assert rep.total_duration == formal.total_duration
    # Def 3's size_i^step unions M_{i-1} with the new loads *before* frees,
    # so it upper-bounds the actual footprint of the free-then-load sequence.
    assert rep.peak_footprint <= formal.peak_footprint
    # DRAM reads = pixels loaded * C_in + kernel elements
    assert rep.elements_read == (strat.pixels_loaded() * spec.c_in
                                 + spec.kernel_elements)
    assert rep.elements_written == spec.num_patches * spec.c_out
    assert rep.total_macs == spec.macs_total


def test_capacity_overflow_detected():
    spec = ConvSpec(2, 6, 6, 2, 3, 3)
    layer = ConvLayer.random(spec)
    tiny = HardwareModel(nbop_pe=10**9, size_mem=spec.kernel_elements + 5)
    with pytest.raises(MemoryError):
        System(layer, tiny).run(zigzag(spec, 3))


def test_pe_capacity_enforced():
    spec = ConvSpec(2, 6, 6, 2, 3, 3)
    layer = ConvLayer.random(spec)
    small_pe = HardwareModel(nbop_pe=spec.nb_op_value * spec.c_out,
                             size_mem=10**9)
    System(layer, small_pe).run(row_by_row(spec, 1))      # 1 patch ok
    with pytest.raises(Exception):
        System(layer, small_pe).run(row_by_row(spec, 2))  # 2 patches too many


def test_trace_rendering():
    spec = ConvSpec(2, 5, 5, 2, 3, 3)
    strat = zigzag(spec, 2)
    grid = render_group_grid(strat)
    assert "zigzag" in grid and len(grid.splitlines()) == spec.h_out + 1
    heat = render_input_heatmap(strat)
    assert len(heat.splitlines()) == spec.h_in + 1
    layer = ConvLayer.random(spec)
    rep = System(layer, HW).run(strat)
    assert all(t.describe(spec) for t in rep.traces)


def test_solver_strategy_runs_functionally():
    from repro_torch.core import solver
    spec = ConvSpec(1, 6, 6, 1, 3, 3)
    res = solver.solve(spec, p=4, hw=HW, time_limit=5, polish_iters=2000,
                       use_milp=False)
    layer = ConvLayer.random(spec)
    rep = System(layer, HW).run(res.strategy)
    assert rep.correct
