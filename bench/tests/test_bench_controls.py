"""On the card, at each cell's own size: the program passes every limit
and the control (the plain reference one precision lower, in the
program's place) fails at least one, on three seeds.  Run there with
``python3 -m pytest -q -m gpu bench/tests/test_bench_controls.py``."""
from __future__ import annotations

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

CELLS = ("resnet8.f32.stream", "resnet8.f32.frame", "qwen2-7b.decode.long",
         "qwen2-7b.decode.short")
SEEDS = (2**31 + 7001, 2**31 + 7002, 2**31 + 7003)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own size")
    import controls
    import run as bench_run
    bench_run.prepare_env(bench_run.ROOT)
    for row in controls.collect(cell, list(SEEDS), 1.0, True):
        checks = row["checks"]
        assert row["correct"], checks
        assert any(c["value"] > c["limit"] for name, c in checks.items()
                   if name.startswith("control.")), checks
