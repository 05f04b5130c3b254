"""The reasoning cell (``setups/moe_hybrid_lm.py``) rehearsed on the CPU at
a tiny size that keeps Nemotron-H's structure (``MEM*EME*``: Mamba-2
blocks with B and C in two groups, sigmoid-routed relu^2 experts beside a
shared one, NoPE GQA blocks), under the cell's own limits: a run is
correct, loads no JAX module, counts what it served, and traces its eager
steps in a session of their own; a run whose timed path is broken (pairs
dropped by the JAX package's capacity, softmax routing in place of the
sigmoid, fp8 inputs to the expert products, the recurrent state rounded
to bfloat16) is not correct.  The reference against the program at the
tiny size: the same weights and tokens give the same logits.  On the
card, at the cell's own size: each of those faults is not correct, and
the program passes every limit while each control (fp8 weights; the
state through bfloat16) fails one, on three seeds (``python3 -m pytest
-q -s -m gpu bench/tests/test_bench_nemotron.py``)."""
from __future__ import annotations

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402

CELL = "nemotron-3-nano-30b-a3b.decode.reason"
TINY = {"hidden_size": 256, "num_hidden_layers": 8,
        "hybrid_override_pattern": "MEM*EME*", "mamba_num_heads": 8,
        "mamba_head_dim": 32, "n_groups": 2, "ssm_state_size": 16,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 32, "n_routed_experts": 64, "num_experts_per_tok": 6,
        "moe_intermediate_size": 32, "moe_shared_expert_intermediate_size":
        64, "vocab_size": 256, "chunk_size": 8}
TINY_MIX = {"batch": 64, "context": 16, "gen": 6, "first_tokens": 4,
            "warm_steps": 1, "events": 16, "trace_steps": 2,
            "eager_steps": 1, "check_sessions": 8}
SEED = 2**31 + 5151


def tiny(cfg: dict, mix: dict) -> None:
    cfg.update(TINY)
    mix.update(TINY_MIX)


def _run(trace: bool = False) -> dict:
    import torch
    bench_run.prepare_env(bench_run.ROOT)
    return bench_run.run_cell(CELL, SEED, 0.2, trace,
                              device=torch.device("cpu"), override=tiny)


def test_a_rehearsal_is_correct_and_reports_its_metrics():
    result = _run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"logit_gap", "kv_rows_err",
                                     "state_err", "state_coarse_share",
                                     "route_shortfall", "expert_out_err"}
    assert result["checks"]["state_err"]["compared"] == \
        TINY_MIX["check_sessions"] * TINY["mamba_num_heads"]
    pairs = TINY_MIX["check_sessions"] * TINY_MIX["gen"] \
        * TINY["hybrid_override_pattern"].count("E")
    assert result["checks"]["route_shortfall"]["compared"] == pairs
    assert result["checks"]["expert_out_err"]["compared"] == pairs
    assert result["attempted"] >= TINY_MIX["batch"]
    assert {"decode_tokens_per_s", "setup_s"} <= set(result["metrics"])
    assert not bench_run.forbidden_modules()


def test_a_traced_rehearsal_reads_no_device_trace():
    """On the CPU every step is eager, the traced sub-window's too: each
    records one ``moe.layer`` tree an expert block and keeps its choices;
    no reader finds a device trace there, so none but the FLOP count
    reports, and none runs the eager steps' own session."""
    from repro_torch.obs import spans
    spans.clear()
    result = _run(trace=True)
    assert result["correct"], result["checks"]
    snap = spans.snapshot()
    roots = [s for s in snap.spans if s.parent < 0]
    layers = TINY["hybrid_override_pattern"].count("E") \
        * TINY_MIX["trace_steps"]
    assert [s.name for s in roots] == ["moe.layer"] * layers
    assert len(spans.RECORDER.kept) == layers
    assert set(result["metrics"]) == {"nemotron_decode_mfu"}
    spans.clear()


def test_the_eager_steps_are_traced_in_a_session_of_their_own():
    """``traced()`` replays its steps alone; its ``eager`` runs, once,
    the fitting replays and the eager steps under a profiler session of
    their own, the program's recorder cleared first, so that the spans
    and choices a reader finds are those steps' alone; the check that
    follows holds the generation they belong to."""
    import torch
    from harness import spec
    from harness import trace as trace_mod
    from repro_torch.obs import spans
    bench_run.prepare_env(bench_run.ROOT)
    bench = spec.load_benchmark(bench_run.ROOT)
    cfg = spec.config(bench, spec.workload(bench, CELL)["config"],
                      bench_run.ROOT)
    mix = spec.traffic(spec.workload(bench, CELL)["traffic"], BENCH)
    tiny(cfg, mix)
    setup = spec.setup_module(cfg["setup"], BENCH)
    cell = setup.Cell(torch, torch.device("cpu"), cfg, mix, SEED)
    cell.build()
    cell.window(0.05)
    _, traced = trace_mod.record(torch, cell.device, cell.traced)
    assert traced["steps"] == TINY_MIX["trace_steps"]
    trace, (t0, t1) = traced["eager"]()
    assert traced["eager"]()[0] is trace and t0 < t1
    roots = [s for s in spans.snapshot().spans if s.parent < 0]
    layers = TINY["hybrid_override_pattern"].count("E") \
        * (setup.FIT_REPLAYS + TINY_MIX["eager_steps"])
    assert [s.name for s in roots] == ["moe.layer"] * layers
    assert spans.RECORDER.kept[0].shape == (TINY_MIX["batch"],
                                            TINY["num_experts_per_tok"])
    spans.clear()
    cell.finish()
    cell.release()
    checks = cell.check()
    assert all(c["value"] <= c["limit"] for c in checks), checks


def fp8_rows(x):
    """``x`` through float8_e4m3fn, each row (last dim) scaled to its
    largest entry: the experts' inputs as an fp8 product takes them."""
    import torch
    scale = x.abs().amax(dim=-1, keepdim=True).float().clamp_min(1e-12) \
        / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale) \
        .to(x.dtype)


def _break(monkeypatch, kind: str) -> None:
    """A fault in the program's timed path (the same code the check's
    block-by-block comparison calls): ``jax_capacity`` routes a decode
    step with the JAX package's capacity (tokens x k / E x 1.25, at least
    8), which drops pairs; ``softmax_router`` scores by the softmax in
    place of the sigmoid; ``fp8_experts`` runs both expert products on
    inputs through fp8; ``bf16_state`` rounds the recurrent state to
    bfloat16 after every update."""
    import torch
    from repro_torch.models import moe, nemotron_h, ssm
    if kind == "jax_capacity":
        def mixer(x, p, cfg):
            return moe.dropless(x, p, cfg, moe._capacity(
                x.shape[0] * x.shape[1], cfg))
        monkeypatch.setattr(nemotron_h, "expert_mixer", mixer)
    elif kind == "softmax_router":
        def route(x, router, bias, top_k, scale):
            probs = torch.softmax(x.float() @ router, dim=-1)
            top_e = torch.topk(probs + bias, top_k, dim=-1).indices
            top_w = probs.gather(-1, top_e)
            return top_w / top_w.sum(-1, keepdim=True) * scale, top_e
        monkeypatch.setattr(moe, "route_sigmoid", route)
    elif kind == "fp8_experts":
        def products(xb, w_up, w_down):
            hid = torch.relu(torch.bmm(fp8_rows(xb), w_up)).square()
            return torch.bmm(fp8_rows(hid), w_down)
        monkeypatch.setattr(moe, "relu2_experts", products)
    else:
        real = ssm.ssd_update

        def update(xbc, dt_raw, dt_bias, a_log, d_skip, h, *, groups):
            y = real(xbc, dt_raw, dt_bias, a_log, d_skip, h, groups=groups)
            h.copy_(h.to(torch.bfloat16))
            return y
        monkeypatch.setattr(ssm, "ssd_update", update)
    assert nemotron_h.moe is moe


def test_the_jax_capacity_drops_pairs_at_the_cells_ratio():
    """At the tiny size as at the published one, the JAX package's
    capacity (tokens x k / E x 1.25, at least 8) is 8 slots for a load
    whose mean is about 6: experts overflow every step."""
    from repro_torch.models import moe
    from repro_torch.models.common import NemotronHConfig
    import torch
    cfg = NemotronHConfig(name="t", family="nemotron_h", n_layers=1,
                          d_model=8, n_heads=1, n_kv_heads=1, d_ff=8,
                          vocab=16, n_experts=TINY["n_routed_experts"],
                          top_k=TINY["num_experts_per_tok"])
    b = TINY_MIX["batch"]
    assert moe._capacity(b, cfg) == 8
    gen = torch.Generator().manual_seed(1)
    scores = torch.rand((b, cfg.n_experts), generator=gen)
    load = torch.bincount(torch.topk(scores, cfg.top_k).indices.reshape(-1),
                          minlength=cfg.n_experts)
    assert int(load.max()) > 8


FAULTS = ["jax_capacity", "softmax_router", "fp8_experts", "bf16_state"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    result = _run()
    assert result["correct"] is False, result["checks"]
    if fault == "bf16_state":
        share = result["checks"]["state_coarse_share"]
        assert share["value"] > share["limit"], share


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not_correct_at_the_cells_size(monkeypatch, fault):
    """On the card, the cell as the benchmark runs it, at its own size
    and limits (a short window), with one fault in the program: not
    correct.  Prints the numbers (``pytest -s``)."""
    import gc
    import json
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    bench_run.prepare_env(bench_run.ROOT)
    gc.collect()
    torch.cuda.empty_cache()
    _break(monkeypatch, fault)
    result = bench_run.run_cell(CELL, 2**31 + 7301, 1.0, False,
                                device=torch.device("cuda", 0))
    checks = result["checks"]
    print(json.dumps({"fault": fault, "correct": result["correct"],
                      "checks": checks}))
    assert result["correct"] is False, checks


@pytest.mark.gpu
def test_the_control_fails_and_the_program_passes_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    import controls
    bench_run.prepare_env(bench_run.ROOT)
    seeds = [2**31 + 7201, 2**31 + 7202, 2**31 + 7203]
    for row in controls.collect(CELL, seeds, 1.0, True):
        checks = row["checks"]
        assert row["correct"], checks
        for tag in ("control", "control.bf16_state"):
            assert any(c["value"] > c["limit"] for name, c in checks.items()
                       if name.rsplit(".", 1)[0] == tag), (tag, checks)


def test_the_reference_is_the_program_on_the_cells_weights():
    """The setup's seeded weights at the tiny size, in float32: the
    reference's full forward pass against the program's prefill, the
    last position's logits, and each block kind's cache entry."""
    import torch
    from harness import spec
    from repro_torch.models import nemotron_h
    from repro_torch.models.common import map_defs
    from repro_torch.models.registry import ModelApi
    bench = spec.load_benchmark(bench_run.ROOT)
    cfg = spec.config(bench, spec.workload(bench, CELL)["config"],
                      bench_run.ROOT)
    cfg.update(TINY)
    setup = spec.setup_module(cfg["setup"], BENCH)
    dev = torch.device("cpu")
    weights = map_defs(lambda t: t.float(),
                       setup.make_weights(torch, cfg, dev, SEED))
    tokens = torch.randint(0, cfg["vocab_size"], (2, 16),
                           generator=torch.Generator().manual_seed(3))
    want = setup.ref.forward(weights, cfg, tokens)
    api = ModelApi(cfg=setup.arch_config(cfg), module=nemotron_h)
    logits, cache = api.prefill_fn(weights, {"tokens": tokens})
    ref_logits = setup.ref.full_logits(weights, want["hidden"])[:, -1]
    scale = ref_logits.abs().max()
    assert (logits - ref_logits).abs().max() / scale < 2e-5
    h = torch.stack(want["h"])
    assert (cache["mamba"]["h"] - h).abs().max() / h.abs().max() < 2e-5
