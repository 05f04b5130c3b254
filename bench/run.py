"""Run one cell of the benchmark once, on the card, and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix and
per-layer metrics are found by the names in ``BENCHMARK.json``
(``harness/spec.py``).  Set-up (``setup_s``: from the start of this
process to the window's start) builds the system under test from the
seed and warms every shape the traffic uses; then the window measures
for ``--seconds``.  With ``--trace 1`` a traced sub-window follows and
the cell's per-layer metrics are read; otherwise its end-to-end metrics.
Once the window has closed the program's state is freed and what the
timed path produced is held against the plain reference.

The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error
and the ``checks`` key, last in that object.  Exits with another code
than 0, and prints no result, without a CUDA device or enough of them,
or when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` has
been loaded.  Compile caches live in fixed directories of the checkout
(``.bench_cache/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_env(root: pathlib.Path) -> None:
    """Fixed cache directories inside the checkout, before anything that
    reads them is imported; no JAX for libraries that would load it."""
    cache = root / ".bench_cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for path in (str(HERE), str(root / "src")):
        if path not in sys.path:
            sys.path.insert(0, path)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX one, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class Run:
    """What a per-layer metric's reader reads: the window's host-clock
    facts and the program's counters (``window``), the traced
    sub-window's (``traced``) and its device trace (``trace``), the cell's
    shapes (``info``) and the benchmark's spans around set-up calls
    (``spans``)."""

    def __init__(self, cell, window: dict, traced: dict, trace):
        self.info, self.spans = cell.info, cell.spans
        self.window, self.traced, self.trace = window, traced, trace


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device, root: pathlib.Path = ROOT, t_start: float | None = None,
             override=None, control: bool = False) -> dict:
    """One run of ``workload``; returns the result object.  ``override``
    (the tests' rehearsal) edits the configuration and the traffic mix
    after they are read."""
    t_start = T_START if t_start is None else t_start
    from harness import spec
    from harness import trace as trace_mod
    import torch
    parts = {"import_s": time.perf_counter() - t_start}
    bench = spec.load_benchmark(root)
    wl = spec.workload(bench, workload)
    cfg = spec.config(bench, wl["config"], root)
    mix = spec.traffic(wl["traffic"], root / "bench")
    if override is not None:
        override(cfg, mix)
    e2e, per_layer = spec.cell_metrics(bench, workload)
    readers = {m["name"]: spec.metric_reader(m["name"], root / "bench")
               for m in per_layer} if trace else {}
    cell = spec.setup_module(cfg["setup"], root / "bench").Cell(
        torch, device, cfg, mix, seed)
    t0 = time.perf_counter()
    torch.zeros(1, device=device)
    parts["device_init_s"] = time.perf_counter() - t0
    cell.build()
    setup_s = time.perf_counter() - t_start
    parts.update(cell.spans)
    window = cell.window(seconds)
    metrics, result_device, breakdown = {}, {}, None
    if trace:
        dtrace, traced = trace_mod.record(torch, device, cell.traced)
        run = Run(cell, window, traced, dtrace)
        for m in per_layer:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device = {"busy_s": dtrace.busy_s(),
                         "window_s": dtrace.window_s}
        breakdown = {"device_ops": dtrace.top_ops(),
                     "idle_gaps": dtrace.idle_gaps()}
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else \
                window.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.finish()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    cell.release()
    t0 = time.perf_counter()
    checks = cell.check(control=control)
    parts["check_s"] = time.perf_counter() - t0
    correct = all(c["value"] <= c["limit"] for c in checks
                  if not c["name"].startswith("control."))
    out = {"correct": correct, "attempted": cell.attempted, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda"
                      else device.type,
                      "kind": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": peak,
                      **result_device}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_parts"] = parts
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                 "compared": c["compared"]} for c in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env(ROOT)
    try:
        import torch
        from harness import spec
        bench = spec.load_benchmark(ROOT)
        chips = spec.workload(bench, args.workload)["chips"]
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is False; the "
                  "benchmark runs on the card only", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} CUDA devices, "
                  f"{torch.cuda.device_count()} are visible", file=sys.stderr)
            return 3
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), device=torch.device("cuda", 0))
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"({c['compared']} compared)", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
