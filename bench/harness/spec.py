"""Find what a cell is made of, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file (its ``file`` in ``configs``) is a JSON
object of sizes whose ``setup`` key names the module under
``bench/setups/`` that builds the system under test from it.  A traffic
mix is ``bench/traffic/<traffic>.json``, parameters only.  A per-layer
metric is read by ``bench/metrics/<name>.py``.  Adding any of them is
adding files: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names is missing or inconsistent."""


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise SpecError(f"no {path}")
    return json.loads(path.read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SpecError(f"no {what} named {name!r}; have "
                    f"{[e['name'] for e in entries]}")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    """The configuration file's object, with its ``name`` and ``source``
    from ``BENCHMARK.json``."""
    entry = _by_name(bench["configs"], name, "configuration")
    cfg = json.loads((root / entry["file"]).read_text())
    cfg.setdefault("name", name)
    cfg.setdefault("source", entry["source"])
    if "setup" not in cfg:
        raise SpecError(f"{entry['file']} names no setup module")
    return cfg


def traffic(name: str, bench_dir: pathlib.Path = BENCH) -> dict:
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.exists():
        raise SpecError(f"no traffic mix {path}")
    return json.loads(path.read_text())


def load_module(path: pathlib.Path, name: str):
    """A Python file loaded by path (metric names hold dots)."""
    if not path.exists():
        raise SpecError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup_module(name: str, bench_dir: pathlib.Path = BENCH):
    return load_module(bench_dir / "setups" / f"{name}.py",
                       f"bench_setup_{name}")


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH):
    mod = load_module(bench_dir / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_")
                      .replace("-", "_"))
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"metrics/{name}.py has no read(run)")
    return mod


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, cell, names)]
    return e2e, per_layer
