"""The host span recorder (``repro_torch.obs.spans``), its spans in the
conv wrapper and the decode step, and the benchmark's clock fit and
readers that put them beside a device trace (``bench/harness/spans.py``,
``bench/metrics/``), on the CPU: spans only under a profiler session,
their tree, the fixed slots, the fit on synthetic traces and each reader
on a synthetic run."""
from __future__ import annotations

import contextlib
import itertools
import pathlib
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import H100_SXM
from repro_torch.kernels import conv2d_offload as conv
from repro_torch.kernels.emit import emit_layer_kernel, plan_emitable_network
from repro_torch.launch.steps import GraphDecodeStep
from repro_torch.obs import spans

BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench"
sys.path.insert(0, str(BENCH))

from harness import spans as hs  # noqa: E402
from harness import spec  # noqa: E402
from harness.trace import DeviceTrace  # noqa: E402

OFFSET_US = 5000.0
CALLS = 200


@pytest.fixture
def recorder():
    spans.clear()
    yield spans.RECORDER
    spans.clear()


@pytest.fixture
def clock(monkeypatch):
    """``spans.now`` as a counter that steps by 10 ns a read."""
    ticks = itertools.count(1000, 10)
    monkeypatch.setattr(spans, "now", lambda: next(ticks))


def _emitted():
    specs = [ConvSpec(c_in=3, h_in=8, w_in=8, n_kernels=4, h_k=3, w_k=3)]
    plan = plan_emitable_network(
        specs, H100_SXM.as_hardware_model(dtype_bytes=4), name="spans")
    return emit_layer_kernel(plan.layers[0])


def test_the_gate_is_the_profilers_flag():
    assert not spans.GATE._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.GATE._is_profiler_enabled
    assert not spans.GATE._is_profiler_enabled


def test_no_span_is_recorded_outside_a_profiler_session(recorder):
    em = _emitted()
    x, w = torch.randn(3, 8, 8), torch.randn(4, 3, 3, 3)
    for _ in range(3):
        em.run(x, w)
    snap = spans.snapshot()
    assert snap.spans == () and snap.dropped == 0


def test_a_cpu_conv_call_records_one_conv_run_alone(recorder):
    em = _emitted()
    x, w = torch.randn(3, 8, 8), torch.randn(4, 3, 3, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        em.run(x, w)
    snap = spans.snapshot()
    assert [s.name for s in snap.spans] == ["conv.run"]
    run = snap.spans[0]
    assert run.parent == -1 and run.arg == em.layer_index
    assert run.end_ns > run.start_ns


def test_a_call_that_raises_still_closes_its_root(recorder):
    em = _emitted()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            em.run(torch.randn(3, 9, 8), torch.randn(4, 3, 3, 3))
    assert [s.name for s in spans.snapshot().spans] == ["conv.run"]


def _fake_step():
    """A ``GraphDecodeStep`` whose graph is a stub, on CPU tensors."""
    step = GraphDecodeStep.__new__(GraphDecodeStep)
    step.tokens = torch.zeros((2, 1), dtype=torch.int64)
    step.pos = torch.zeros((), dtype=torch.int32)
    step.graph = types.SimpleNamespace(replay=lambda: None)
    step.logits = torch.zeros((2, 5))
    step.replays = 0
    return step


def test_the_decode_step_records_its_span_tree(recorder, clock,
                                               monkeypatch):
    step = _fake_step()
    step(torch.ones((2, 1), dtype=torch.int64), 7)
    assert spans.snapshot().spans == ()
    monkeypatch.setattr(spans, "GATE",
                        types.SimpleNamespace(_is_profiler_enabled=True))
    step(torch.ones((2, 1), dtype=torch.int64), 8)
    step(torch.ones((2, 1), dtype=torch.int64), torch.tensor(9))
    snap = spans.snapshot()
    names = [s.name for s in snap.spans]
    assert names == ["decode.step", "decode.tokens", "decode.pos",
                     "decode.replay"] * 2
    assert [s.arg for s in snap.spans if s.parent < 0] == [1, 2]
    assert [s.parent for s in snap.spans] == [-1, 0, 0, 0, -1, 4, 4, 4]
    assert snap.spans[0].root != snap.spans[4].root
    assert {s.root for s in snap.spans[:4]} == {snap.spans[0].root}
    assert step.replays == 3 and int(step.pos) == 9
    # each child starts where the one before it ended, the first at the
    # root's start
    for k in (0, 4):
        tree = snap.spans[k:k + 4]
        assert tree[1].start_ns == tree[0].start_ns
        assert [c.start_ns for c in tree[2:]] == \
            [c.end_ns for c in tree[1:3]]


def test_nesting_parents_and_self_time(clock):
    rec = spans.SpanRecorder()
    t0 = rec.root()                                   # 1000
    a = spans.now()                                   # 1010
    b = spans.now()                                   # 1020
    rec.add(spans.CONV_CHECK, b)                      # ends 1030
    rec.add(spans.CONV_GEOMETRY, a)                   # ends 1040
    c = spans.now()                                   # 1050
    rec.add(spans.CONV_LAUNCH, c)                     # ends 1060
    rec.add(spans.CONV_RUN, t0, 4)                    # ends 1070
    snap = rec.snapshot()
    assert [(s.name, s.start_ns, s.end_ns, s.parent) for s in snap.spans] \
        == [("conv.run", 1000, 1070, -1), ("conv.geometry", 1010, 1040, 0),
            ("conv.check", 1020, 1030, 1), ("conv.launch", 1050, 1060, 0)]
    assert snap.children() == [[1, 3], [2], [], []]
    assert snap.self_ns() == [70 - 30 - 10, 30 - 10, 10, 10]
    assert snap.spans[0].arg == 4 and {s.root for s in snap.spans} == {1}


@pytest.fixture
def stub_launch(monkeypatch):
    """A planned launch on CPU tensors: no current device, no device
    context, stream 0, and a launch function that returns 0.  Returns a
    call with a given ``span``."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    x, w = torch.randn(3, 8, 8), torch.randn(4, 3, 3, 3)
    counter = torch.zeros(1, dtype=torch.int64)

    def call(span):
        return conv.planned_launch(
            x, w, t_run=3, s_h=1, s_w=1, order="zigzag", cluster=(1, 1),
            counter=counter, launch=lambda *args: 0
        ).run(x, w, conv._lambda_matrix, span)
    return call


def test_children_record_only_while_a_root_is_open(recorder, stub_launch):
    with profile(activities=[ProfilerActivity.CPU]):
        out = stub_launch(0)
    assert out.shape == (4, 6, 6)
    assert spans.snapshot().spans == ()
    t0 = recorder.root()
    stub_launch(t0)
    recorder.add(spans.CONV_RUN, t0)
    names = [s.name for s in spans.snapshot().spans]
    assert names[0] == "conv.run" and "conv.launch" in names


def test_the_launch_path_chains_its_children(recorder, stub_launch,
                                             clock):
    """From the span it is handed, each part's span starts where the one
    before it ended; ``conv.launch`` holds the launcher's whole call, the
    code's check and the count with it."""
    t0 = recorder.root()
    stub_launch(t0)
    recorder.add(spans.CONV_RUN, t0, 2)
    snap = spans.snapshot()
    assert [s.name for s in snap.spans] == [
        "conv.run", "conv.lambda", "conv.alloc", "conv.launch"]
    assert [s.parent for s in snap.spans] == [-1, 0, 0, 0]
    kids = snap.spans[1:]
    assert kids[0].start_ns == t0
    assert [c.start_ns for c in kids[1:]] == [c.end_ns for c in kids[:-1]]
    assert snap.spans[0].end_ns > kids[-1].end_ns


def test_overflow_counts_into_dropped_and_the_list_stays_bounded(clock):
    rec = spans.SpanRecorder(capacity=spans.CALL_SPANS + 3)
    for layer in range(3):
        t0 = rec.root()
        if t0:
            rec.add(spans.CONV_LAUNCH, spans.now())
            rec.add(spans.CONV_RUN, t0, layer)
    snap = rec.snapshot()
    assert [s.arg for s in snap.spans if s.parent < 0] == [0, 1]
    assert len(snap.spans) == 4 and snap.dropped == 1
    assert len(rec._log) == 5 * 4 <= 5 * rec.capacity
    rec.clear()
    assert rec.snapshot() == spans.SpanSnapshot((), 0)


# ------------------------------------------------------------------ #
# synthetic traces: host spans in ns, trace events in us, OFFSET_US apart
# ------------------------------------------------------------------ #

def _event(cat, name, a, b, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a,
            "args": {"correlation": corr}}


def _span(name, a_us, b_us, parent, root, arg=0):
    return spans.HostSpan(name, int(a_us * 1000), int(b_us * 1000), parent,
                          root, arg)


def _conv_case(calls=CALLS, drop=(), call=(62, 65), jitter=True,
               shift=0.0):
    """Call c: ``conv.run`` [100c, 100c+80] us, its ``conv.launch``
    [100c+60, 100c+70]; on the trace's clock K1's runtime call at
    ``call`` (+ c % 3 with ``jitter``) and its kernel [100c+70, 100c+90].
    ``shift`` moves the second half of the spans."""
    out, events = [], []
    for c in range(calls):
        base = 100.0 * c + (shift if c >= calls // 2 else 0.0)
        i = len(out)
        out += [_span("conv.run", base, base + 80, -1, c + 1, c % 7),
                _span("conv.check", base + 1, base + 2, i, c + 1),
                _span("conv.launch", base + 60, base + 70, i, c + 1)]
        at = 100.0 * c + OFFSET_US
        j = (c % 3) if jitter else 0
        if c not in drop:
            events.append(_event("cuda_runtime", "cudaLaunchKernelExC",
                                 at + call[0] + j, at + call[1] + j, c))
        events.append(_event("cuda_runtime", "cudaLaunchKernel",
                             at + 20, at + 21, 10_000 + c))
        events.append(_event("kernel", "conv2d_offload_planned_kernel",
                             at + 70, at + 90, c))
    return spans.SpanSnapshot(tuple(out), 0), DeviceTrace(events, 0.02)


def _tight_conv_case():
    """K1's runtime call fills its ``conv.launch``: the fit is exact."""
    return _conv_case(call=(60, 70), jitter=False)


def _decode_case(steps=16):
    """Step s: ``decode.step`` [1000s, 1000s+300] us with its three
    children, ``decode.replay`` [240, 290]; on the trace's clock
    ``cudaGraphLaunch`` at 250-280 and the graph's work [290, 900]."""
    out, events = [], []
    for s in range(steps):
        base = 1000.0 * s
        i = len(out)
        out += [_span("decode.step", base, base + 300, -1, s + 1, s),
                _span("decode.tokens", base + 10, base + 50, i, s + 1),
                _span("decode.pos", base + 60, base + 100, i, s + 1),
                _span("decode.replay", base + 240, base + 290, i, s + 1)]
        at = base + OFFSET_US
        events.append(_event("cuda_runtime", "cudaGraphLaunch", at + 250,
                             at + 280, s))
        events.append(_event("kernel", "gemm", at + 290, at + 900, s))
    return spans.SpanSnapshot(tuple(out), 0), DeviceTrace(events, 0.02)


def test_the_clock_fit_is_exact_on_consistent_spans():
    snap, trace = _conv_case(jitter=False)
    fit = hs.fit_clock(snap, trace, *hs.CONV_CALL)
    # a call [62, 65] inside a span [60, 70]: offsets O - 5 to O + 2
    assert fit.matched == fit.spans == CALLS
    assert fit.width_us == pytest.approx(7.0)
    assert fit.offset_us == pytest.approx(OFFSET_US - 1.5)
    snap, trace = _conv_case()
    fit = hs.fit_clock(snap, trace, *hs.CONV_CALL)
    # the calls at +0, +1, +2 narrow it to O - 3 to O + 2
    assert fit.width_us == pytest.approx(5.0)
    assert fit.offset_us - fit.width_us / 2 <= OFFSET_US \
        <= fit.offset_us + fit.width_us / 2


def test_the_clock_fit_holds_through_a_dropped_runtime_event():
    snap, trace = _conv_case(drop=(0, 57))
    fit = hs.fit_clock(snap, trace, *hs.CONV_CALL)
    assert fit is not None and fit.matched == CALLS - 2
    assert abs(fit.offset_us - OFFSET_US) <= fit.width_us / 2
    snap, trace = _conv_case(drop=(3, 4, 5))
    assert hs.fit_clock(snap, trace, *hs.CONV_CALL) is None


def test_the_clock_fit_refuses_inconsistent_spans_and_dropped_spans():
    snap, trace = _conv_case(shift=30.0)
    assert hs.fit_clock(snap, trace, *hs.CONV_CALL) is None
    snap, trace = _conv_case()
    dropped = spans.SpanSnapshot(snap.spans, 1)
    assert hs.fit_clock(dropped, trace, *hs.CONV_CALL) is None
    assert hs.fit_clock(None, trace, *hs.CONV_CALL) is None
    assert hs.fit_clock(snap, DeviceTrace([], 0.0), *hs.CONV_CALL) is None


def test_idle_gaps_are_laid_against_the_innermost_span():
    snap, trace = _conv_case(jitter=False, calls=3)
    fit = hs.Fit(OFFSET_US, 0.0, 3, 3)
    # gaps [90, 170] and [190, 270]: outside [90, 100], conv.run's own
    # time [100, 101], conv.check [101, 102], conv.run [102, 160],
    # conv.launch [160, 170]
    got = hs.idle_by_span(trace, snap, fit)
    assert got == pytest.approx({hs.OUTSIDE: 2 * 10e-6,
                                 "conv.run": 2 * 59e-6,
                                 "conv.check": 2 * 1e-6,
                                 "conv.launch": 2 * 10e-6})


def test_the_decode_fit_holds_each_graph_launch_in_its_replay():
    snap, trace = _decode_case()
    fit = hs.fit_clock(snap, trace, *hs.DECODE_CALL)
    # a call [250, 280] inside a span [240, 290]: offsets O - 10 to O + 10
    assert fit.matched == fit.spans == 16
    assert fit.offset_us == pytest.approx(OFFSET_US)
    assert fit.width_us == pytest.approx(20.0)
    # each gap [900, 1290] after a step: outside the program [900, 1000],
    # decode.step's own [1000, 1010], [1050, 1060], [1100, 1240], tokens
    # [1010, 1050], pos [1060, 1100], replay [1240, 1290]
    got = hs.idle_by_span(trace, snap, fit)
    assert got == pytest.approx({hs.OUTSIDE: 15 * 100e-6,
                                 "decode.step": 15 * 160e-6,
                                 "decode.tokens": 15 * 40e-6,
                                 "decode.pos": 15 * 40e-6,
                                 "decode.replay": 15 * 50e-6})


def _run(info, snap_trace):
    snap, trace = snap_trace
    return types.SimpleNamespace(info=info, trace=trace, spans={},
                                 window={}, traced={}), snap


READERS = {
    "conv_prep_us.stream": ({"mode": "stream"}, _tight_conv_case, 70.0),
    "conv_prep_us.frame": ({"mode": "frame"}, _tight_conv_case, 70.0),
    "conv_launch_us.stream": ({"mode": "stream"}, _tight_conv_case, 10.0),
    "conv_launch_us.frame": ({"mode": "frame"}, _tight_conv_case, 10.0),
    # each gap [90, 170] of a call holds the next call's prep [100, 160]
    "conv_idle_in_prep.stream": ({"mode": "stream"}, _tight_conv_case,
                                 75.0),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_on_a_synthetic_run(name, monkeypatch):
    info, case, want = READERS[name]
    reader = spec.metric_reader(name, BENCH)
    run, snap = _run(info, case())
    monkeypatch.setattr(hs, "recorded", lambda: snap)
    assert reader.read(run) == pytest.approx(want)
    other = {"mode": "frame" if info.get("mode") == "stream" else "stream"} \
        if "mode" in info else {"mode": "stream"}
    assert reader.read(_run(other, case())[0]) is None
    monkeypatch.setattr(hs, "recorded", lambda: None)
    assert reader.read(run) is None


def test_the_readers_read_the_programs_recorder(recorder, clock):
    for layer in range(2):
        t0 = recorder.root()
        t = spans.now()
        recorder.add(spans.CONV_LAUNCH, t)
        recorder.add(spans.CONV_RUN, t0, layer)
    snap = hs.recorded()
    assert [s.name for s in snap.spans] == ["conv.run", "conv.launch"] * 2
    # a call: root at +0, launch from +10 to +20, end at +30
    assert hs.conv_split_us(snap) == pytest.approx((0.02, 0.01))


def test_a_timed_window_records_no_span(recorder):
    sys.path.insert(0, str(BENCH / "tests"))
    import run as bench_run
    from rehearse import tiny
    result = bench_run.run_cell("resnet8.f32.stream", 11, 0.3, False,
                                device=torch.device("cpu"), override=tiny)
    assert result["correct"] and result["attempted"] > 0
    assert spans.snapshot() == spans.SpanSnapshot((), 0)
