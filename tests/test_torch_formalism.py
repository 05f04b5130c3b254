"""The cases of ``tests/test_formalism.py``, read on ``repro_torch`` with
the same inputs and settings. The reference's docstring follows.

Unit tests for the offloading formalism (paper Sec 2) against the
paper's own worked examples.
"""
import pytest

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.formalism import (MemoryState, Step, StepError,
                                        apply_step, run_steps, step_duration)
from repro_torch.core.strategies import row_by_row, zigzag
from _torch_port import fast_polish_port  # noqa: F401


EX_SPEC = ConvSpec(c_in=2, h_in=5, w_in=5, n_kernels=2, h_k=3, w_k=3)
EX_HW = HardwareModel(nbop_pe=120)


def test_example1_patch_count():
    # Example 1: 2x5x5 input, two 2x3x3 kernels, stride 1 -> 9 patches.
    assert EX_SPEC.num_patches == 9
    assert EX_SPEC.num_pixels == 25          # Example 3 (Remark 6)
    assert EX_SPEC.nb_op_value == 18         # Def 13: 2*3*3


def test_example1_patch_windows():
    # P_{0,0}, P_{1,1}, P_{2,2} of Fig 7.
    assert EX_SPEC.patch_bbox(EX_SPEC.patch_id(0, 0)) == (0, 0, 3, 3)
    assert EX_SPEC.patch_bbox(EX_SPEC.patch_id(1, 1)) == (1, 1, 4, 4)
    assert EX_SPEC.patch_bbox(EX_SPEC.patch_id(2, 2)) == (2, 2, 5, 5)


def _spatial(spec, mask):
    return sorted(spec.pixel_pos(j) for j in spec.pixels_of_mask(mask))


def test_example2_row_by_row_step2():
    steps = row_by_row(EX_SPEC, 2).to_steps()
    s2 = steps[1]
    assert _spatial(EX_SPEC, s2.f_inp) == [(0, 0), (0, 1)]
    assert _spatial(EX_SPEC, s2.i_slice) == [
        (0, 4), (1, 4), (2, 4), (3, 0), (3, 1), (3, 2)]
    assert s2.w.bit_count() == 2             # outputs of g_1
    assert s2.k_sub == 0
    # delta(s_2) = 6 t_l + 2 t_w + t_acc  (paper Example 2)
    assert step_duration(s2, EX_SPEC, EX_HW) == 6 + 2 + 1


def test_example2_zigzag_step2():
    steps = zigzag(EX_SPEC, 2).to_steps()
    s2 = steps[1]
    assert _spatial(EX_SPEC, s2.f_inp) == [
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
    assert _spatial(EX_SPEC, s2.i_slice) == [
        (0, 4), (1, 4), (2, 4), (3, 2), (3, 3), (3, 4)]
    assert step_duration(s2, EX_SPEC, EX_HW) == 6 + 2 + 1


def test_example2_memory_footprints():
    # M_2^inp: Row = 32 elements, ZigZag = 24 elements (paper Example 2).
    r = run_steps(row_by_row(EX_SPEC, 2).to_steps(), EX_SPEC, EX_HW)
    z = run_steps(zigzag(EX_SPEC, 2).to_steps(), EX_SPEC, EX_HW)
    assert r.states[1].inp.bit_count() * EX_SPEC.c_in == 32
    assert z.states[1].inp.bit_count() * EX_SPEC.c_in == 24


def test_nb_patches_max_formula():
    # Sec 4.2 formula: floor(120 / (18 * 2)) = 3.  (The paper's prose says
    # 2 for this example — inconsistent with its own definition; we follow
    # the definition.  See EXPERIMENTS.md.)
    assert EX_HW.nb_patches_max_s1(EX_SPEC.nb_op_value, EX_SPEC.c_out) == 3


def test_semantics_reject_bad_steps():
    m = MemoryState()
    with pytest.raises(StepError):
        apply_step(m, Step(f_inp=1))          # freeing what is not loaded
    m2 = apply_step(m, Step(i_slice=0b11))
    with pytest.raises(StepError):
        apply_step(m2, Step(i_slice=0b01))    # reload while resident
    with pytest.raises(StepError):
        apply_step(m2, Step(w=1))             # write-back of nothing


def test_run_rejects_incomplete_strategy():
    spec = ConvSpec(1, 4, 4, 1, 3, 3)
    hw = HardwareModel(nbop_pe=10**6)
    strat = row_by_row(spec, 2)
    steps = strat.to_steps()[:-2]             # drop last compute + flush
    with pytest.raises(StepError):
        run_steps(steps, spec, hw)


def test_memory_empty_after_last_step():
    r = run_steps(zigzag(EX_SPEC, 2).to_steps(), EX_SPEC, EX_HW)
    assert r.states[-1].empty


def test_s1_kernels_resident_until_last_step():
    steps = row_by_row(EX_SPEC, 2).to_steps()
    r = run_steps(steps, EX_SPEC, EX_HW)
    for st in r.states[:-1]:
        assert st.ker.bit_count() == EX_SPEC.n_kernels
    assert steps[0].k_sub.bit_count() == EX_SPEC.n_kernels
    assert all(s.k_sub == 0 for s in steps[1:])
    assert steps[-1].f_ker.bit_count() == EX_SPEC.n_kernels
