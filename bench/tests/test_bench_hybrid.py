"""The hybrid decode cell (``setups/hybrid_lm.py``) rehearsed on the CPU at
a tiny size that keeps Zamba2's structure (4 layers, both shared blocks,
B and C in two groups): a run is correct under the cell's limits, loads
no JAX module, counts what it served; a run whose timed path is broken
(the recurrent state left unwritten or kept in bfloat16, half of the
batch's attention left out, a logit altered where it is made) is not
correct.  On the card, at
the cell's own size, the program passes every limit and each control
(fp8 weights; the state through bfloat16) fails one, on three seeds (``python3 -m pytest -q -m gpu
bench/tests/test_bench_hybrid.py``); at the tiny size the limits, set at
the published widths, are not the control's."""
from __future__ import annotations

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402

CELL = "zamba2-7b.decode.chat"
TINY = {"hidden_size": 1024, "num_hidden_layers": 4, "hybrid_layer_ids": [1, 3],
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 512, "vocab_size": 256, "mamba_headdim": 64,
        "mamba_d_state": 16, "chunk_size": 8, "adapter_rank": 8}
TINY_MIX = {"batch": 4, "context": 16, "gen": 4, "first_tokens": 4,
            "warm_steps": 1, "events": 8, "trace_steps": 2,
            "check_sessions": 4}
SEED = 2**31 + 4242


def tiny(cfg: dict, mix: dict) -> None:
    cfg.update(TINY)
    mix.update(TINY_MIX)


def _run(control: bool = False) -> dict:
    import torch
    bench_run.prepare_env(bench_run.ROOT)
    return bench_run.run_cell(CELL, SEED, 0.2, False,
                              device=torch.device("cpu"), override=tiny,
                              control=control)


def test_a_rehearsal_is_correct_and_reports_its_metrics():
    result = _run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"logit_gap", "kv_rows_err",
                                     "state_err", "state_coarse_share"}
    heads = 2 * TINY["hidden_size"] // TINY["mamba_headdim"]
    assert result["checks"]["state_err"]["compared"] == \
        TINY_MIX["check_sessions"] * heads
    assert result["attempted"] >= TINY_MIX["batch"]
    assert {"decode_tokens_per_s", "setup_s"} <= set(result["metrics"])
    assert not bench_run.forbidden_modules()


def _break(monkeypatch, kind: str) -> None:
    import torch
    from repro_torch.models import ssm, zamba2
    if kind == "unchanged":
        monkeypatch.setattr(ssm, "_write", lambda dst, src: None)
    elif kind == "bf16_state":
        real_write = ssm._write

        def write(dst, src):
            real_write(dst, src.to(torch.bfloat16) if dst.dtype ==
                       torch.float32 else src)
        monkeypatch.setattr(ssm, "_write", write)
    elif kind == "half_batch":
        real = zamba2.decode_attend

        def attend(q, k, v, lengths, scale=None):
            out = real(q, k, v, lengths, scale=scale)
            out[out.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(zamba2, "decode_attend", attend)
    else:
        real = zamba2._logits
        calls = {"n": 0}

        def logits(x, lm_head):
            out = real(x, lm_head)
            calls["n"] += 1
            if calls["n"] % 3 == 0:
                out[0, calls["n"] % out.shape[1]] += 1e4
            return out
        monkeypatch.setattr(zamba2, "_logits", logits)


@pytest.mark.parametrize("fault", ["unchanged", "bf16_state", "half_batch",
                                   "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    result = _run()
    assert result["correct"] is False, result["checks"]


@pytest.mark.gpu
def test_the_control_fails_and_the_program_passes_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    import controls
    bench_run.prepare_env(bench_run.ROOT)
    seeds = [2**31 + 7101, 2**31 + 7102, 2**31 + 7103]
    for row in controls.collect(CELL, seeds, 1.0, True):
        checks = row["checks"]
        assert row["correct"], checks
        for tag in ("control", "control.bf16_state"):
            assert any(c["value"] > c["limit"] for name, c in checks.items()
                       if name.rsplit(".", 1)[0] == tag), (tag, checks)
