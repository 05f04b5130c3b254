"""The benchmark's Nemotron-H counts (``bench/harness/nemotron_counts.py``)
against the program's own shapes: the parameter count against
``registry.get("nemotron-3-nano-30b-a3b")``'s parameters as ``meta``
tensors (31.58 B, 3.23 B of them a token's step reads, as published:
31.6B-A3.2B), the state's bytes against ``cache_defs``' at the cell's
batch, a decode step's FLOPs and an expert layer's least bytes by hand at
a tiny size; and the readers of the expert layer's spans
(``bench/harness/moe_trace.py``, ``bench/metrics/moe_share.reason.py``,
``moe_expert_roofline.reason.py``) on a synthetic trace."""
import json
import pathlib
import sys
import types

import pytest
import torch

from repro_torch.models import nemotron_h, registry
from repro_torch.models.common import abstract_params, leaves
from repro_torch.models.transformer import cache_rows
from repro_torch.obs import spans

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
sys.path.insert(0, str(BENCH))

from harness import moe_trace, nemotron_counts, spec  # noqa: E402
from harness import spans as hs  # noqa: E402
from harness.trace import DeviceTrace  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "nemotron-3-nano-30b-a3b.json")
                    .read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "decode.reason.json").read_text())


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def test_the_parameter_count_is_the_programs_and_the_published_one():
    api = registry.get("nemotron-3-nano-30b-a3b")
    params = abstract_params(api.param_defs())
    got = sum(t.numel() for t in leaves(params))
    assert nemotron_counts.param_count(CONFIG) == got == api.count_params()
    assert got == 31_577_940_288
    assert nemotron_counts.active_param_count(CONFIG) == 3_227_754_816
    # 63.2 GB in bfloat16, the routers and the mixers' constants in f32
    assert _bytes(params) == pytest.approx(63.2e9, rel=2e-3)


def test_the_state_bytes_are_the_caches_at_the_cells_batch():
    api = registry.get("nemotron-3-nano-30b-a3b")
    b = TRAFFIC["batch"]
    rows = cache_rows(api.cfg, b, TRAFFIC["context"] + TRAFFIC["gen"])
    cache = abstract_params(api.cache_defs(b, rows))
    assert nemotron_counts.state_bytes(CONFIG, b) == _bytes(cache["mamba"])
    # 23 blocks x 64 sessions x 64 heads x 64 x 128 x 4 bytes of state
    assert _bytes({"h": cache["mamba"]["h"]}) == \
        23 * 64 * 64 * 64 * 128 * 4
    assert cache["attn"]["k"].shape == (6, b, rows, 2, 128)
    assert rows == 5120


TINY = {"hidden_size": 8, "mamba_num_heads": 4, "mamba_head_dim": 2,
        "n_groups": 2, "ssm_state_size": 3, "conv_kernel": 4,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
        "n_routed_experts": 5, "num_experts_per_tok": 2,
        "moe_intermediate_size": 6, "moe_shared_expert_intermediate_size": 7,
        "n_shared_experts": 1, "hybrid_override_pattern": "MEM*E",
        "vocab_size": 10}


@pytest.mark.parametrize("length", [1, 9])
def test_decode_step_flops_by_hand(length):
    # Mamba: in_proj 8 x (2*8 + 2*6 + 4) = 8 x 32, out_proj 8 x 8
    mamba = 8 * 32 + 8 * 8
    # experts: the router 8 x 5, two experts' up and down 2 x 2 x 8 x 6,
    # the shared expert's 2 x 8 x 7
    moe = 8 * 5 + 2 * 2 * 8 * 6 + 2 * 8 * 7
    # attention: q 8 x 8, k and v 8 x 4 each, o 8 x 8
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    state = 2 * 6 * 4 * 2 * 3            # two Mamba blocks, 4 heads (2, 3)
    qk_pv = 4 * 2 * length * 4
    want = 2 * (2 * mamba + 2 * moe + attn + 8 * 10) + state + qk_pv
    assert nemotron_counts.decode_step_flops(TINY, 3, length) == 3 * want
    # every parameter: the embedding and the head, the final norm, each
    # block's norm and mixer (the Mamba block's conv of 4 x 20 and 20
    # biases, A, D and dt's bias by head, the gated norm's 8; the router's
    # bias)
    m_block = 8 + mamba + 4 * 20 + 20 + 3 * 4 + 8
    e_block = 8 + 8 * 5 + 5 + 5 * 2 * 8 * 6 + 2 * 8 * 7
    a_block = 8 + attn
    total = 2 * 10 * 8 + 8 + 2 * m_block + 2 * e_block + a_block
    assert nemotron_counts.param_count(TINY) == total
    assert nemotron_counts.active_param_count(TINY) == \
        total - 10 * 8 - 2 * 3 * 2 * 8 * 6


def test_an_expert_layers_least_work_by_hand():
    # 3 experts chosen, 4 pairs: each expert's up and down read once in
    # bf16, each pair's row in and out
    flops, nbytes = nemotron_counts.expert_least(TINY, 3, 4)
    assert flops == 4 * 2 * 2 * 8 * 6
    assert nbytes == 3 * 2 * 8 * 6 * 2 + 2 * 4 * 8 * 2


# ------------------------- readers, synthetic ------------------------- #

OFFSET_US = 5000.0


def _span(name, t0, t1, parent, root):
    return spans.HostSpan(name, int(t0 * 1e3), int(t1 * 1e3), parent, root, 0)


def _case():
    """The eager steps' own session: two graph replays (each
    ``decode.replay`` holding its ``cudaGraphLaunch``), then an eager step
    of one expert layer: kernels launched at 1000 (before the layer), 1010
    and 1020 (its route and experts), 1040 (after it); device times 5, 7,
    11 and 13 us.  The traced sub-window's trace is another: one replay's
    kernel."""
    host = []
    for i, t in enumerate((100.0, 200.0)):
        host.append(_span("decode.step", t, t + 20, -1, i + 1))
        host.append(_span("decode.replay", t + 5, t + 15, len(host) - 1,
                          i + 1))
    root = len(host)
    host += [_span("moe.layer", 1005, 1035, -1, 3),
             _span("moe.route", 1005, 1015, root, 3),
             _span("moe.experts", 1015, 1030, root, 3),
             _span("moe.combine", 1030, 1035, root, 3)]
    snap = spans.SpanSnapshot(tuple(host), 0)
    runtime, device = [], []
    for i, t in enumerate((100.0, 200.0)):
        runtime.append({"ph": "X", "cat": "cuda_runtime",
                        "name": "cudaGraphLaunch", "ts": t + 6 + OFFSET_US,
                        "dur": 8, "args": {"correlation": 10 + i}})
        device.append({"ph": "X", "cat": "kernel", "name": "graphed",
                       "ts": t + 20 + OFFSET_US, "dur": 50,
                       "args": {"correlation": 10 + i}})
    for corr, (t, dur) in enumerate(((1000, 5), (1010, 7), (1020, 11),
                                     (1040, 13)), start=20):
        runtime.append({"ph": "X", "cat": "cuda_runtime",
                        "name": "cudaLaunchKernel", "ts": t + OFFSET_US,
                        "dur": 2, "args": {"correlation": corr}})
        device.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                       "ts": t + 100 + OFFSET_US, "dur": dur,
                       "args": {"correlation": corr}})
    trace = DeviceTrace(runtime + device, 1.0)
    replays = DeviceTrace(runtime[:1] + device[:1], 1.0)
    run = types.SimpleNamespace(
        trace=replays, traced={"steps": 2, "eager": lambda: (
            trace, (990_000, 1_050_000))},
        info={"model": CONFIG, "batch": 4})
    return run, snap


def test_the_expert_layers_device_time_by_span(monkeypatch):
    run, snap = _case()
    monkeypatch.setattr(hs, "recorded", lambda: snap)
    secs = moe_trace.eager_seconds(run)
    assert secs["layers"] == 1
    assert secs["all"] == pytest.approx(36e-6)
    assert secs["moe.layer"] == pytest.approx(18e-6)
    assert secs["moe.experts"] == pytest.approx(11e-6)
    share = spec.metric_reader("moe_share.reason", BENCH).read(run)
    assert share == pytest.approx(50.0)
    # one layer whose 4 tokens chose experts {0, 1, 2}: 8 pairs
    routes = [torch.tensor([[0, 1], [1, 2], [0, 2], [2, 1]])]
    monkeypatch.setattr(moe_trace, "kept", lambda: routes)
    flops, nbytes = nemotron_counts.expert_least(CONFIG, 3, 8)
    least = max(flops / 989e12, nbytes / 3.35e12)
    roof = spec.metric_reader("moe_expert_roofline.reason", BENCH).read(run)
    assert roof == pytest.approx(least / 11e-6 * 100.0)
    # choices kept for more layers than spans: nothing is read
    monkeypatch.setattr(moe_trace, "kept", lambda: routes * 2)
    assert spec.metric_reader("moe_expert_roofline.reason",
                              BENCH).read(run) is None


def test_the_readers_give_nothing_without_spans_or_eager_steps(monkeypatch):
    run, snap = _case()
    monkeypatch.setattr(hs, "recorded", lambda: None)
    assert moe_trace.eager_seconds(run) is None
    assert spec.metric_reader("moe_share.reason", BENCH).read(run) is None
    monkeypatch.setattr(hs, "recorded", lambda: snap)
    run.traced = {"steps": 2}
    assert moe_trace.eager_seconds(run) is None
    for name in ("moe_share.reason", "moe_expert_roofline.reason",
                 "k5_roofline.reason", "ssd_update_roofline.reason",
                 "nemotron_decode_mfu"):
        other = types.SimpleNamespace(trace=None, traced={}, window={},
                                      info={"model": {}, "batch": 1})
        assert spec.metric_reader(name, BENCH).read(other) is None
