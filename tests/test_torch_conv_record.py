"""The planned kernel's launch record (``conv2d_offload.PlannedLaunch``)
and the records ``EmittedConv`` keeps, on the CPU: what a record derives
from a plan is what the geometry helpers give, a layer too large for one
block is refused as before, Λ is reused only for the same weights
unchanged, the cache leaves ``EmittedConv``'s identity alone, and the
benchmark's reader of the Λ counter.  The launch itself runs on the card
(``tests/test_torch_gpu.py``)."""
from __future__ import annotations

import dataclasses
import functools
import pathlib
import sys
import types

import pytest
import torch

from repro_torch.configs.networks import NETWORKS
from repro_torch.core.cost_model import H100_SXM, HardwareModel
from repro_torch.core.planner import conv_cluster_shape
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels import conv2d_offload as conv
from repro_torch.kernels.emit import emit_layer_kernel, plan_emitable_network
from repro_torch.obs.counters import COUNTS
from repro_torch.reference_io import emitted_from_fields

BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASES = [(name, budget, dtype, layer) for name, specs in NETWORKS.items()
         for budget in ("h100", "2xLambda") for dtype in DTYPES
         for layer in range(len(specs))]


def _stub_launch(*args):
    return 0


@functools.cache
def _emitted(name: str, budget: str, dtype: str) -> tuple:
    specs = list(NETWORKS[name])
    if budget == "h100":
        hw = H100_SXM.as_hardware_model(
            dtype_bytes=torch.empty((), dtype=DTYPES[dtype]).element_size())
    else:
        hw = HardwareModel(nbop_pe=1 << 20,
                           size_mem=2 * max(s.kernel_elements for s in specs))
    plan = plan_emitable_network(specs, hw, name=name)
    return tuple(emit_layer_kernel(lp) for lp in plan.layers)


def _tensors(em, dtype=torch.float32, seed=0):
    s = em.spec
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((s.c_in, s.h_in, s.w_in), generator=gen).to(dtype)
    w = torch.randn((s.c_out, s.c_in, s.h_k, s.w_k), generator=gen).to(dtype)
    return x, w


def _record(em, x, w, **kw):
    s = em.spec
    return conv.planned_launch(x, w, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w,
                               order=em.order, launch=_stub_launch, **kw)


@pytest.mark.parametrize("name,budget,dtype,layer", CASES)
def test_the_record_holds_what_the_geometry_helpers_give(name, budget,
                                                         dtype, layer):
    em = _emitted(name, budget, dtype)[layer]
    s = em.spec
    x, w = _tensors(em, DTYPES[dtype])
    n, h_k, w_k, h_out, tiles = conv._conv_geometry(x, w, em.t_run, s.s_h,
                                                    s.s_w)
    row_delta, col_delta = conv._planned_flags(h_k, w_k, s.s_h, s.s_w,
                                               em.t_run, tiles, em.order)
    smem = conv.planned_smem_elements(
        s.c_in, n, h_k, w_k, s.s_h, s.s_w, em.t_run,
        row_delta=row_delta) * x.element_size()
    if smem > conv.SMEM_LIMIT_BYTES:
        with pytest.raises(KernelShapeError, match="shared memory"):
            _record(em, x, w)
        return
    rec = _record(em, x, w)
    cs_n, cs_t = conv_cluster_shape(n, em.t_run)
    assert (rec.n, rec.h_k, rec.w_k, rec.h_out, rec.tiles) == \
        (n, h_k, w_k, h_out, tiles)
    assert (rec.c_in, rec.h_in, rec.w_in) == (s.c_in, s.h_in, s.w_in)
    assert (rec.row_delta, rec.col_delta) == (row_delta, col_delta)
    assert rec.smem_bytes == smem and rec.cluster == (cs_n, cs_t)
    assert rec.out_shape == (n, h_out, tiles * em.t_run)
    assert (rec.device, rec.dtype) == (x.device, x.dtype)
    assert rec.launch.c is _stub_launch
    assert rec.launch.name == "conv2d_offload_planned"
    assert rec.counter is conv.fetched_counter(x.device)
    # the 17 ints after the four pointers, in PLANNED_ARGTYPES' order
    assert len(rec.ints) == len(conv.PLANNED_ARGTYPES) - 5
    assert rec.ints == (
        {"float32": 0, "bfloat16": 1}[dtype], s.c_in, s.h_in, s.w_in, n,
        h_k, w_k, s.s_h, s.s_w, em.t_run, h_out, tiles,
        int(em.order == "zigzag"), int(row_delta), int(col_delta), cs_n,
        cs_t)


def test_a_layer_too_large_for_one_block_is_refused_when_its_record_is_made():
    """Λ of 512 -> 512 3x3 kernels is 9 MB, its eighth 1.2 MB: refused
    before any launcher is bound, with the wrapper's own message."""
    x = torch.zeros((512, 6, 6))
    w = torch.zeros((512, 512, 3, 3))
    with pytest.raises(KernelShapeError, match="shared memory per block"):
        conv.planned_launch(x, w, t_run=4, s_h=1, s_w=1, order="zigzag")


def test_a_measurements_cluster_counter_and_launcher_are_kept():
    x, w = torch.randn(3, 8, 8), torch.randn(16, 3, 3, 3)
    counter = torch.zeros(1, dtype=torch.int64)
    rec = conv.planned_launch(x, w, t_run=6, s_h=1, s_w=1, order="row",
                              cluster=(1, 1), counter=counter,
                              launch=_stub_launch)
    assert rec.cluster == (1, 1) and rec.ints[-2:] == (1, 1)
    assert rec.counter is counter and rec.launch.c is _stub_launch
    assert rec.smem_bytes == 4 * conv.planned_layout(
        3, 16, 3, 3, 1, 1, 6, row_delta=rec.row_delta, cluster=(1, 1)).total


def test_the_record_refuses_shapes_the_plan_does_not_take():
    x, w = torch.randn(3, 8, 8), torch.randn(4, 3, 3, 3)
    with pytest.raises(KernelShapeError, match="must divide"):
        conv.planned_launch(x, w, t_run=4, s_h=1, s_w=1, order="zigzag",
                            launch=_stub_launch)
    with pytest.raises(KernelShapeError, match="channels"):
        conv.planned_launch(x, torch.randn(4, 2, 3, 3), t_run=3, s_h=1,
                            s_w=1, order="zigzag", launch=_stub_launch)


@pytest.fixture
def counts(monkeypatch):
    """``LAMBDA`` from zero for the test."""
    monkeypatch.setattr(conv, "LAMBDA", {"built": 0, "reused": 0})
    return conv.LAMBDA


def test_lambda_is_reused_only_for_the_same_weights_unchanged(counts):
    em = _emitted("resnet8", "h100", "float32")[1]
    x, w = _tensors(em)
    rec = _record(em, x, w)
    lam = rec.lambda_of(w)
    assert torch.equal(lam, conv._lambda_matrix(w)) and lam.is_contiguous()
    assert counts == {"built": 1, "reused": 0}
    assert rec.lambda_of(w) is lam and rec.lambda_of(w) is lam
    assert counts == {"built": 1, "reused": 2}
    # an in-place edit bumps the version: made anew
    w.mul_(2)
    doubled = rec.lambda_of(w)
    assert doubled is not lam and torch.equal(doubled, 2 * lam)
    assert torch.equal(doubled, conv._lambda_matrix(w))
    assert counts == {"built": 2, "reused": 2}
    # another tensor with equal values: made anew, and kept in its turn
    twin = w.clone()
    got = rec.lambda_of(twin)
    assert got is not doubled and torch.equal(got, doubled)
    assert rec.lambda_of(twin) is got
    assert counts == {"built": 3, "reused": 3}
    # the first tensor again: it was not kept, so made anew
    assert rec.lambda_of(w) is not got
    assert counts == {"built": 4, "reused": 3}


def test_lambda_is_made_anew_for_another_dtype_and_another_storage(counts):
    em = _emitted("resnet8", "h100", "float32")[0]
    x, w = _tensors(em)
    rec = _record(em, x, w)
    lam = rec.lambda_of(w)
    low = w.to(torch.bfloat16)
    got = rec.lambda_of(low)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, conv._lambda_matrix(low))
    # the same object given another storage without a version bump
    rec.lambda_of(w)
    w.data = torch.zeros_like(w)
    assert torch.equal(rec.lambda_of(w), torch.zeros_like(lam))
    assert counts == {"built": 4, "reused": 0}


def test_a_filled_cache_leaves_equality_hash_and_rebuild_alone():
    em = _emitted("resnet8", "h100", "float32")[2]
    rebuilt = emitted_from_fields(dataclasses.asdict(em.spec), em.t_run,
                                  em.order, em.layer_index)
    x, w = _tensors(em)
    rec = em.launches[(x.device, x.dtype)] = _record(em, x, w)
    rec.lambda_of(w)
    assert em == rebuilt and hash(em) == hash(rebuilt)
    assert rebuilt.launches == {} and em.launches[(x.device, x.dtype)] is rec
    assert "launches" not in repr(em) and repr(em) == repr(rebuilt)
    again = dataclasses.replace(em)
    assert again == em and again.launches == {}
    assert {f.name for f in dataclasses.fields(em) if f.init} == {
        "spec", "grid_meta", "layer_index", "vmem_elements"}


def test_cpu_calls_take_the_plain_version_and_count_no_lambda(counts):
    em = _emitted("resnet8", "h100", "float32")[6]
    x, w = _tensors(em)
    launches = COUNTS["conv2d_offload_planned"]
    out = em.run(x, w)
    assert torch.equal(out, conv.conv2d_offload_planned_plain(
        x, w, t_run=em.t_run, s_h=em.spec.s_h, s_w=em.spec.s_w,
        order=em.order))
    assert em.launches == {} and counts == {"built": 0, "reused": 0}
    assert COUNTS["conv2d_offload_planned"] == launches


def test_every_input_check_still_raises_before_any_record():
    em = _emitted("tight2", "h100", "float32")[0]
    x, w = _tensors(em)
    with pytest.raises(KernelShapeError, match="input"):
        em.run(x[:, 1:], w)
    with pytest.raises(KernelShapeError, match="kernels"):
        em.run(x, w[1:])
    with pytest.raises(KernelShapeError, match="float32 or both bfloat16"):
        em.run(x, w.to(torch.bfloat16))
    with pytest.raises(KernelShapeError, match="float32 or both bfloat16"):
        em.run(x.double(), w.double())
    with pytest.raises(KernelShapeError, match="contiguous"):
        em.run(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    assert em.launches == {}


def _reader():
    sys.path.insert(0, str(BENCH))
    from harness import spec
    return spec.metric_reader("conv_lambda_reuse.stream", BENCH)


@pytest.mark.parametrize("mode,built,reused,want", [
    ("stream", 7, 69993, 99.99), ("stream", 7, 0, 0.0),
    ("stream", 0, 0, None), ("frame", 7, 69993, None)])
def test_the_reuse_reader_gives_the_share_of_reused_lambdas(
        counts, mode, built, reused, want):
    counts.update(built=built, reused=reused)
    run = types.SimpleNamespace(info={"mode": mode})
    got = _reader().read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_the_reuse_reader_reads_nothing_from_a_program_without_the_counter(
        monkeypatch):
    monkeypatch.delattr(conv, "LAMBDA")
    run = types.SimpleNamespace(info={"mode": "stream"})
    assert _reader().read(run) is None
