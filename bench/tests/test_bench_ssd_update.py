"""The hybrid decode cell's state checks against faults put where the
program now updates the recurrent state: ``ssm.ssd_update``
(``kernels/ssd_update.py``), which writes each layer's state in place, so
that no state passes through ``ssm._write`` on the un-meshed path.  A
state rounded to bfloat16 after every update, or left as it was, is not
correct.  Rehearsed on the CPU at ``test_bench_hybrid.py``'s tiny size
(``python3 -m pytest -q bench/tests/test_bench_ssd_update.py``)."""
from __future__ import annotations

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from test_bench_hybrid import _run  # noqa: E402


def _break(monkeypatch, kind: str) -> None:
    import torch
    from repro_torch.models import ssm
    real = ssm.ssd_update

    def update(xbc, dt_raw, dt_bias, a_log, d_skip, h, *, groups):
        kept = h.clone()
        y = real(xbc, dt_raw, dt_bias, a_log, d_skip, h, groups=groups)
        if kind == "bf16_state":
            h.copy_(h.to(torch.bfloat16))
        else:
            h.copy_(kept)
        return y
    monkeypatch.setattr(ssm, "ssd_update", update)


@pytest.mark.parametrize("fault", ["bf16_state", "unchanged_state"])
def test_a_broken_state_update_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    result = _run()
    assert result["correct"] is False, result["checks"]
    if fault == "bf16_state":
        share = result["checks"]["state_coarse_share"]
        assert share["value"] > share["limit"], share
