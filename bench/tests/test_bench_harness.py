"""The harness on the CPU: the contract of ``BENCHMARK.json``, the loader
finding cells, mixes and metrics added as files, rehearsals of every
cell at a tiny size with no JAX module loaded, and the refusals."""
from __future__ import annotations

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402
from harness import spec  # noqa: E402

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _env() -> dict:
    """A subprocess environment without the repository's source on the
    path, as a checkout's run has."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def _rehearse(*args, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(pathlib.Path(cwd) / "bench" / "tests"
                             / "rehearse.py"), *args],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=600)


def test_benchmark_json_keeps_the_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        got = [e["name"] for e in bench[key]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith("bench/")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        ends, layers = spec.cell_metrics(bench, w["name"])
        reported = {m["name"] for m in ends}
        assert "setup_s" in reported and len(reported) >= 2 and layers
        assert all(m["moves"] in reported for m in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_a_rehearsal_loads_no_jax_and_is_correct(cell):
    got = _rehearse(cell, "--trace", "1", "--modules")
    assert got.returncode == 0, got.stderr[-3000:]
    result = json.loads(got.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert not set(result["modules"]) & set(bench_run.FORBIDDEN)
    assert "repro_torch" in result["modules"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"repro_torch", "repro", "jax", "jaxlib",
                                    "flax"}, (path.name, tops)
    code = ("import sys; sys.path.insert(0, 'bench'); "
            "import reference.conv2d, reference.qwen2; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    loaded = set(ast.literal_eval(got.stdout.strip()))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_run_refuses_without_a_cuda_device():
    got = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_a_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    got = _rehearse(CELLS[0], cwd=tmp_path)
    assert got.returncode != 0
    assert not got.stdout.strip()


def test_new_config_mix_and_metric_are_found_as_files(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as files only: the loader finds them and a run reports the metric."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    cfg = json.loads((BENCH / "configs" / "resnet8.json").read_text())
    cfg["layers"] = cfg["layers"][5:]
    (tmp_path / "bench" / "configs" / "resnet8-tail.json").write_text(
        json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "stream.json").read_text())
    mix.update(pool_images=4, check_every=1, warm_passes=1, reserve=1,
               trace_passes=2)
    (tmp_path / "bench" / "traffic" / "burst.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "passes_seen.py").write_text(
        "def read(run):\n    return float(run.window['passes'])\n")
    bench["configs"].append({"name": "resnet8-tail", "source": "x",
                             "file": "bench/configs/resnet8-tail.json",
                             "reduced": [], "why": "two layers"})
    bench["workloads"].append({"name": "resnet8-tail.burst",
                               "config": "resnet8-tail", "traffic": "burst",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "passes_seen", "unit": "passes",
                               "better": "higher", "source": "host_clock",
                               "layer": "network pass",
                               "moves": "images_per_s",
                               "workloads": ["resnet8-tail.burst"]})
    bench["end_to_end"][0]["workloads"].append("resnet8-tail.burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_benchmark(tmp_path)
    assert spec.config(loaded, "resnet8-tail", tmp_path)["layers"] == \
        cfg["layers"]
    assert spec.traffic("burst", tmp_path / "bench")["pool_images"] == 4
    _, layers = spec.cell_metrics(loaded, "resnet8-tail.burst")
    assert "passes_seen" in {m["name"] for m in layers}

    import torch
    bench_run.prepare_env(ROOT)
    result = bench_run.run_cell("resnet8-tail.burst", 7, 0.2, True,
                                device=torch.device("cpu"), root=tmp_path)
    assert result["correct"]
    assert result["metrics"]["passes_seen"]["value"] >= 1
