#!/usr/bin/env python3
"""The program's host spans in the benchmark's cells: what they cost, how
the clock fit holds, and where the device's idle time goes.

    python3 tools/span_probe.py [--cell NAME ...] [--seed N] [--seconds S]
        [--turns N] [--json PATH] [--tiny]
        [--against ROOT [--pairs N] [--passes N]]

For each cell of ``BENCHMARK.json`` named (all by default) it builds the
cell as ``bench/run.py`` does, then:

1. runs a window of ``--seconds`` with no profiler session and counts the
   spans the recorder holds after it (0 expected), with the host
   microseconds a conv call took to return (``conv_enqueue_us``);
2. runs the work of the cell's traced sub-window (300 passes or 16
   steps) ``--turns`` times each way, in turns (off, on, on, off, ...),
   with the recorder's gate forced off and on: first with no profiler
   session (the spans' own cost, and the split of a call as the timed
   window has it), then under the benchmark's profiler session.  For each
   it prints the host microseconds a conv call or a decode step took to
   return (a wrapper times the step's calls) and, traced, the device's
   idle share; with the gate on also each span's mean self time a root
   call and, traced, the clock fit (offset, width, spans matched), every
   per-layer metric of the cell as its reader gives it, and the idle gaps
   laid against the innermost span open during them
   (``harness/spans.py``);
3. times the recorder alone on this host: a call's root and child spans
   (conv: 5 children, decode: 3) with the gate on and off, beside the
   same calls without the span sites (``loop_ns``).

With ``--against ROOT`` it also times, in a conv cell, this tree's
``EmittedConv.run`` against the conv wrapper's source of the checkout
at ``ROOT`` (its span recorder and conv wrapper: ``obs/spans.py``,
``kernels/_build.py``, ``kernels/conv2d_offload.py`` and
``kernels/emit.py``, loaded beside this tree's package) in one process:
``--pairs`` pairs of blocks of ``--passes`` passes, the two sides in
turns and the first side alternating, with no profiler and the gate
forced off (the host microseconds a call took to return, each side's
median and quartiles and those of the pairs' differences, this tree's
less the other's), then ``--turns`` pairs with the gate forced on (each
span's mean self time a call, each side).

``--tiny`` runs the cells at the CPU rehearsal's sizes
(``bench/tests/rehearse.py``).  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
sys.path.insert(0, str(BENCH))

import run as bench_run  # noqa: E402

SEED = 2718281828


def build(name: str, seed: int, tiny: bool, torch, device):
    from harness import spec
    bench = spec.load_benchmark(ROOT)
    wl = spec.workload(bench, name)
    cfg = spec.config(bench, wl["config"], ROOT)
    mix = spec.traffic(wl["traffic"], BENCH)
    if tiny:
        sys.path.insert(0, str(BENCH / "tests"))
        from rehearse import tiny as shrink
        shrink(cfg, mix)
    _, per_layer = spec.cell_metrics(bench, name)
    readers = {m["name"]: spec.metric_reader(m["name"], BENCH)
               for m in per_layer}
    cell = spec.setup_module(cfg["setup"], BENCH).Cell(
        torch, device, cfg, mix, seed)
    cell.build()
    return cell, readers


def timed_steps(cell) -> list:
    """Wrap a decode cell's step so that each call's host seconds add up
    in the returned ``[seconds, calls]``."""
    acc = [0.0, 0]
    step, clock = cell.step, time.perf_counter

    def call(tokens, pos):
        t0 = clock()
        out = step(tokens, pos)
        acc[0] += clock() - t0
        acc[1] += 1
        return out
    cell.step = call
    return acc


def turn(cell, readers, gate_on: bool, profiled: bool, acc, torch,
         device) -> dict:
    """The cell's traced sub-window's work once, with the recorder's gate
    forced on or off, under the benchmark's profiler session or with
    none."""
    from harness import spans as hs
    from harness import trace as trace_mod
    from repro_torch.obs import spans
    spans.clear()
    gate = spans.GATE
    spans.GATE = types.SimpleNamespace(_is_profiler_enabled=gate_on)
    try:
        if acc is not None:
            acc[0], acc[1] = 0.0, 0
        if profiled:
            dtrace, traced = trace_mod.record(torch, device, cell.traced)
        else:
            dtrace, traced = None, cell.traced()
    finally:
        spans.GATE = gate
    out = {"gate": gate_on, "profiled": profiled}
    if dtrace:
        out["device_idle"] = (1 - dtrace.busy_s() / dtrace.window_s) * 100
    if acc is None:
        out["call_us"] = traced["calls_s"] / traced["calls"] * 1e6
    elif acc[1]:
        out["call_us"] = acc[0] / acc[1] * 1e6
    snap = spans.snapshot()
    out["spans"], out["dropped"] = len(snap.spans), snap.dropped
    if not gate_on:
        return out
    roots = [s for s in snap.spans if s.parent < 0]
    out["root_us"] = sum(s.end_ns - s.start_ns for s in roots) \
        / max(1, len(roots)) / 1e3
    self_ns: dict = {}
    for s, own in zip(snap.spans, snap.self_ns()):
        self_ns[s.name] = self_ns.get(s.name, 0) + own
    out["self_us_per_call"] = {k: v / max(1, len(roots)) / 1e3
                               for k, v in self_ns.items()}
    if not profiled:
        return out
    run = bench_run.Run(cell, {}, traced, dtrace)
    out["metrics"] = {name: r.read(run) for name, r in readers.items()}
    call = hs.CONV_CALL if acc is None else hs.DECODE_CALL
    fit = hs.fit_clock(snap, dtrace, *call)
    out["fit"] = fit._asdict() if fit else None
    if fit:
        out["idle_by_span_s"] = hs.idle_by_span(dtrace, snap, fit)
    return out


def recorder_cost(n: int = 20000) -> dict:
    """Nanoseconds a call's spans cost the host, the recorder alone: a
    root that reads the gate and hands its start down through two
    functions, as the call sites do, with the conv path's 5 children and
    the decode step's 3, beside the same calls without the span sites
    (``loop_ns``)."""
    from repro_torch.obs import spans
    conv = ((spans.CONV_CHECK,),
            (spans.CONV_GEOMETRY, spans.CONV_LAMBDA, spans.CONV_ALLOC,
             spans.CONV_LAUNCH))
    decode = ((), (spans.DECODE_TOKENS, spans.DECODE_POS,
                   spans.DECODE_REPLAY))

    def inner(names, t):
        for name in names:
            if t:
                t = spans.RECORDER.add(name, t)
        return t

    def call(shape):
        t0 = spans.RECORDER.root() if spans.GATE._is_profiler_enabled \
            else 0
        try:
            inner(shape[1], inner(shape[0], t0))
        finally:
            if t0:
                spans.RECORDER.add(spans.CONV_RUN, t0, 1)

    def bare_inner(names):
        for _ in names:
            pass

    def bare(shape):
        try:
            bare_inner(shape[1])
            bare_inner(shape[0])
        finally:
            pass

    out, gate = {}, spans.GATE
    try:
        for label, shape in (("conv", conv), ("decode", decode)):
            for way in ("loop", "off", "on"):
                spans.GATE = types.SimpleNamespace(
                    _is_profiler_enabled=way == "on")
                spans.clear()
                fn = bare if way == "loop" else call
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    fn(shape)
                out[f"{label}.{way}_ns"] = (time.perf_counter_ns() - t0) / n
                spans.clear()
    finally:
        spans.GATE = gate
    return out


def wrapper_of(root: pathlib.Path):
    """``EmittedConv`` and the span recorder's module of the conv
    wrapper's source in the checkout at ``root`` (``obs/spans.py``,
    ``kernels/_build.py``, ``kernels/conv2d_offload.py`` and
    ``kernels/emit.py``, each importing those before it), loaded under
    names of their own beside this tree's package, whose other modules
    they share."""
    import importlib
    import importlib.util
    own = {}
    try:
        for part in ("obs.spans", "kernels._build", "kernels.conv2d_offload",
                     "kernels.emit"):
            sub, leaf = part.split(".")
            spec = importlib.util.spec_from_file_location(
                f"against_{leaf}",
                root / "src" / "repro_torch" / sub / f"{leaf}.py")
            mod = sys.modules[spec.name] = \
                importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            # what the next part imports, by module name or from the package
            name = f"repro_torch.{part}"
            package = importlib.import_module(f"repro_torch.{sub}")
            own[name] = (package, leaf, sys.modules[name],
                         getattr(package, leaf))
            sys.modules[name] = mod
            setattr(package, leaf, mod)
        return mod.EmittedConv, sys.modules["against_spans"]
    finally:
        for name, (package, leaf, mod, attr) in own.items():
            sys.modules[name] = mod
            setattr(package, leaf, attr)


def against(cell, root: pathlib.Path, args, torch) -> dict:
    """This tree's conv calls against those of the wrapper at ``root``,
    in one process, on the cell's plan, inputs and weights (see the
    module's docstring)."""
    import dataclasses
    from repro_torch.obs import spans
    other_cls, other_spans = wrapper_of(root)
    sides = {"this": list(cell.emitted),
             "other": [other_cls(**{f.name: getattr(em, f.name)
                                    for f in dataclasses.fields(em)
                                    if f.init})
                       for em in cell.emitted]}
    recorder = {"this": spans, "other": other_spans}
    pool, weights, n = cell.pool, cell.weights, len(cell.order)
    clock = time.perf_counter
    sync = cell._sync
    img = [0]

    def block(ems) -> float:
        took = 0.0
        for _ in range(args.passes):
            i = cell.order[img[0] % n]
            img[0] += 1
            for layer, em in enumerate(ems):
                a = clock()
                em.run(pool[layer][i], weights[layer])
                took += clock() - a
        sync()
        return took / (args.passes * len(ems)) * 1e6

    def gated(on: bool, side: str):
        sp = recorder[side]
        gate = sp.GATE
        sp.GATE = types.SimpleNamespace(_is_profiler_enabled=on)
        sp.clear()
        try:
            return block(sides[side])
        finally:
            sp.GATE = gate

    for side in sides:
        gated(False, side)
    calls = {side: [] for side in sides}
    for k in range(args.pairs):
        for side in (("this", "other") if k % 2 else ("other", "this")):
            calls[side].append(gated(False, side))
    split = {side: [] for side in sides}
    for k in range(args.turns):
        for side in (("this", "other") if k % 2 else ("other", "this")):
            gated(True, side)
            snap = recorder[side].snapshot()
            roots = max(1, sum(s.parent < 0 for s in snap.spans))
            own: dict = {}
            for s, ns in zip(snap.spans, snap.self_ns()):
                own[s.name] = own.get(s.name, 0) + ns
            split[side].append({k_: v / roots / 1e3 for k_, v in own.items()})
            recorder[side].clear()
    diffs = [a - b for a, b in zip(calls["this"], calls["other"])]

    def summary(vals):
        return {"median": statistics.median(vals),
                "quartiles": statistics.quantiles(vals, n=4)}
    return {"against": str(root), "pairs": args.pairs,
            "passes": args.passes,
            "call_us": {side: summary(v) for side, v in calls.items()},
            "diff_us": summary(diffs),
            "this_faster": sum(d < 0 for d in diffs),
            "self_us_per_call": {
                side: {name: statistics.median(t[name] for t in turns
                                               if name in t)
                       for name in sorted({k_ for t in turns for k_ in t})}
                for side, turns in split.items()}}


def probe(name, args, torch, device) -> dict:
    from repro_torch.obs import spans
    cell, readers = build(name, args.seed, args.tiny, torch, device)
    acc = timed_steps(cell) if hasattr(cell, "step") else None
    spans.clear()
    w = cell.window(args.seconds)
    out = {"cell": name, "window_s": w["elapsed_s"],
           "spans_after_window": len(spans.snapshot().spans)}
    if acc is None:
        out["conv_enqueue_us"] = w["calls_s"] / w["calls"] * 1e6
    else:
        out["step_call_us"] = acc[0] / max(1, acc[1]) * 1e6
    turns = []
    for profiled in (False, True):
        for t in range(args.turns):
            for gate_on in ((False, True) if t % 2 == 0 else (True, False)):
                turns.append(turn(cell, readers, gate_on, profiled, acc,
                                  torch, device))
                print(json.dumps({"cell": name, **turns[-1]}), flush=True)
    out["turns"] = turns
    for key in ("call_us", "device_idle", "root_us"):
        for profiled in (False, True):
            for gate_on in (False, True):
                vals = [tr[key] for tr in turns if key in tr
                        and (tr["gate"], tr["profiled"]) == (gate_on,
                                                             profiled)]
                if vals:
                    out[f"{key}.{'traced' if profiled else 'untraced'}."
                        f"{'on' if gate_on else 'off'}"] = \
                        statistics.median(vals)
    if args.against and acc is None:
        out["against"] = against(cell, pathlib.Path(args.against), args,
                                 torch)
        print(json.dumps({"cell": name, **out["against"]}), flush=True)
    cell.finish()
    cell.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--json")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--against")
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--passes", type=int, default=30)
    args = ap.parse_args(argv)
    bench_run.prepare_env(ROOT)
    import torch
    from harness import spec
    device = torch.device("cpu") if args.tiny else torch.device("cuda", 0)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device (or --tiny on the CPU)", file=sys.stderr)
        return 3
    names = args.cell or [w["name"] for w in
                          spec.load_benchmark(ROOT)["workloads"]]
    result = {"device": torch.cuda.get_device_name(0)
              if device.type == "cuda" else "cpu",
              "recorder_cost": recorder_cost(), "cells": []}
    print(json.dumps({"recorder_cost": result["recorder_cost"]}), flush=True)
    for name in names:
        got = probe(name, args, torch, device)
        result["cells"].append(got)
        print(json.dumps({k: v for k, v in got.items() if k != "turns"}),
              flush=True)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
