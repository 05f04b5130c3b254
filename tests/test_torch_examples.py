"""The port's examples (``examples/torch_*.py``) on the CPU, each in a
subprocess.

The five host-only examples print the reference example's output line for
line, run with the same arguments beside it: the port's framework-free
stack equals the JAX package's bit for bit.  Only the planners' wall-clock
seconds differ from one run to the next, and are masked in both.  In
``torch_optimize_offload`` the beyond-paper bridge plans the H100's CUDA
kernels in place of the TPU's Pallas ones, so from its heading on the
lines are the port's own.  ``torch_serve_decode`` and ``torch_train_lm``
run on the card by default: here they are asked for ``--device cpu``, and
without it they stop, for there is no fallback.  No ``torch_*`` example
imports ``repro`` or ``jax``.
"""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PORTED = ("quickstart", "plan_network", "plan_multichip",
          "optimize_offload", "s2_memory_scaling", "serve_decode",
          "train_lm")
# host-only examples and the (small) arguments both versions get
HOST_ONLY = {
    "quickstart": [],
    "plan_network": ["tight2"],
    "plan_multichip": [],
    "s2_memory_scaling": [],
    "optimize_offload": [],
}
BRIDGE = "== H100 planner: same formalism choosing CUDA kernel schedules =="
# the planners' wall-clock figures, which no two runs share
_CLOCK = re.compile(r"planned in [0-9.]+s(, [0-9.]+ layers/s)?")


def _env() -> dict:
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "") \
        if env.get("PYTHONPATH") else src
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _start(script: str, args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(EXAMPLES / script), *args],
                            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> tuple[int, str, str]:
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def _lines(out: str) -> list[str]:
    return [_CLOCK.sub("planned in <s>", line) for line in out.splitlines()]


@pytest.mark.parametrize("name", sorted(HOST_ONLY))
def test_a_host_only_example_prints_the_references_lines(name):
    args = HOST_ONLY[name]
    mine = _start(f"torch_{name}.py", args)
    theirs = _start(f"{name}.py", args)
    rc, out, err = _finish(mine)
    ref_rc, ref_out, ref_err = _finish(theirs)
    assert rc == 0, err
    assert ref_rc == 0, ref_err
    got, want = _lines(out), _lines(ref_out)
    if name == "optimize_offload":
        cut = got.index(BRIDGE)
        assert want[cut].startswith("== TPU planner")
        got, want = got[:cut], want[:cut]
        assert any(line.startswith("matmul 4096x4096x4096")
                   for line in _lines(out)[cut:])
    assert got and got == want


def test_serve_decode_on_the_cpu_when_asked():
    rc, out, err = _finish(_start("torch_serve_decode.py",
                                  ["--device", "cpu"]))
    assert rc == 0, err
    assert "sampled continuation ids:" in out
    counts = json.loads(out.split("decode kernel launches ", 1)[1])
    assert counts["shape"] == [4, 12]
    # the plain versions launch nothing, and the CPU steps are eager
    assert counts["counted"] == {"flash_decode": 0,
                                 "flash_decode_combine": 0}
    assert counts["replays"] == 0


def test_train_lm_on_the_cpu_when_asked_lowers_the_loss():
    rc, out, err = _finish(_start(
        "torch_train_lm.py",
        ["--device", "cpu", "--steps", "10", "--batch", "2",
         "--seq-len", "32"]))
    assert rc == 0, err
    first, last = map(float, re.search(
        r"loss ([0-9.]+) \(first \d+\) -> ([0-9.]+)", out).groups())
    assert last < first


@pytest.mark.skipif(
    torch.cuda.is_available(),
    reason="shows that the examples do not fall back from a card that "
           "is missing")
def test_the_card_examples_stop_without_a_card():
    procs = [_start("torch_serve_decode.py", []),
             _start("torch_train_lm.py", ["--steps", "1"])]
    for proc in procs:
        rc, _, err = _finish(proc)
        assert rc != 0
        assert "no CUDA device is available" in err


@pytest.mark.parametrize("name", PORTED)
def test_a_port_example_imports_neither_repro_nor_jax(name):
    tree = ast.parse((EXAMPLES / f"torch_{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"repro", "jax", "jaxlib"}
