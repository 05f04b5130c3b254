"""A run whose timed path is broken underneath the harness comes out not
correct: the harness's look for a chip skipped (the CPU rehearsal,
``rehearse.py``), the rest of a run driven, once for each fault a cell
can have (its state left unchanged, half of the batch left out, an
answer altered where it is made; no cell spans chips, so none leaves out
an exchange).  The control, the reference one precision lower in the
program's place, fails the convolution's limit here too; the decoder's
control is read at the cell's size on the card
(``test_bench_controls.py``)."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
REHEARSE = BENCH / "tests" / "rehearse.py"
sys.path.insert(0, str(BENCH / "tests"))

from rehearse import FAULTS  # noqa: E402

CELLS = ("resnet8.f32.stream", "resnet8.f32.frame", "qwen2-7b.decode.long",
         "qwen2-7b.decode.short")


def _run(*args) -> dict:
    got = subprocess.run([sys.executable, str(REHEARSE), *args],
                         cwd=BENCH.parent, capture_output=True, text=True,
                         timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result = _run(cell, "--fault", fault, "--seconds", "0.5")
    assert result["correct"] is False, result["checks"]


def test_the_conv_control_fails_its_limit():
    result = _run("resnet8.f32.stream", "--control")
    checks = result["checks"]
    assert result["correct"]
    assert checks["control.conv_out_err"]["value"] > \
        checks["control.conv_out_err"]["limit"]
