#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100): builds the CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's main
path at ResNet-8's full width, and times the kernels.

    python3 chip_smoke.py [--json PATH]

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. card and set-up: ``nvidia-smi``'s name and power limit, versions, the
   build of ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc`` per source,
   started together) and what ``ptxas`` says of each kernel;
2. each kernel against its plain version on the card, at every ResNet-8
   layer's shape and plan and at the geometry cases of the CPU tests, both
   sweep orders, float32 and bfloat16;
3. the main path: ``NETWORKS["resnet8"]`` planned with
   ``plan_emitable_network`` under ``H100_SXM``'s shared-memory budget,
   every layer emitted, seeded inputs run through ``EmittedConv.run`` (the
   planned kernel) and ``ops.conv2d`` (the simple kernel), each output held
   against the oracle ``ref.conv2d``; the launch counters are set to 0
   just before and must show every call just after;
4. times per layer: each kernel's wrapper, its plain version,
   ``F.conv2d`` as the library call, and the bound from the card's
   data-sheet rates.

The second-to-last line is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  There is no CPU mode: without a CUDA
device the script exits non-zero before anything else.  It imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20260311
INPUTS_PER_LAYER = 8
KERNEL_NAMES = ("conv2d_offload", "conv2d_offload_planned")

# Tolerances, |got - want| <= atol + rtol * |want|.  float32: both sides sum
# at most 576 products in f32, in another order.  bfloat16: products and sum
# are exact in f32 on both sides, so the results differ by the final
# rounding to bfloat16, one unit in the last place (2**-7 relative).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1.6e-2, 1e-2)}

# Data-sheet rates of the H100 SXM used for the bound (NVIDIA's data sheet):
# device memory, dense bf16 on the tensor cores, float32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (c_in, h, w, n, kh, kw, sh, sw, t_run): the geometry cases of the CPU
# tests of the planned kernel, each run in both sweep orders.
GEOMETRY_CASES = [
    (2, 10, 12, 3, 3, 3, 1, 1, 5),     # col-delta within rows + row turns
    (1, 9, 9, 2, 3, 3, 1, 1, 7),       # one tile per row: row-delta only
    (2, 11, 13, 3, 3, 3, 2, 2, 3),     # strides 2
    (3, 12, 14, 4, 5, 3, 1, 2, 2),     # tall kernel, stride-2 columns
    (1, 8, 8, 2, 1, 1, 1, 1, 4),       # 1x1 kernel: full fetch per tile
    (2, 13, 11, 3, 3, 3, 3, 1, 9),     # s_h >= h_k: no row-to-row reuse
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--json", type=pathlib.Path, default=None, metavar="PATH",
        help="also write every layer's times, per dtype, to this file")
    json_path = parser.parse_args().json

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False); this "
             "script runs on the card only")

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.networks import NETWORKS
    from repro_torch.core import planner
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import conv2d_offload as conv
    from repro_torch.kernels.emit import (emit_layer_kernel,
                                          kernel_vmem_elements,
                                          plan_emitable_network)
    from repro_torch.reference_io import layer_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full f32
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rng = np.random.default_rng(SEED)

    def make_layer(c_in, h, w, n, kh, kw, dtype):
        x = rng.standard_normal((c_in, h, w)).astype(np.float32)
        k = rng.standard_normal((n, c_in, kh, kw)).astype(np.float32)
        return layer_from_numpy(x, k, dtype=dtype)

    def max_err_within(got, want, dtype_name, what):
        """Largest |got - want|; fails the run when outside tolerance."""
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{what}: got {tuple(got.shape)} {got.dtype}, want "
                 f"{tuple(want.shape)} {want.dtype}")
        g, w_ = got.float(), want.float()
        if not bool(torch.isfinite(g).all()):
            fail(f"{what}: output is not finite")
        rtol, atol = TOL[dtype_name]
        err = (g - w_).abs()
        if bool((err > atol + rtol * w_.abs()).any()):
            fail(f"{what}: max abs err {err.max().item():.3e} outside "
                 f"rtol={rtol} atol={atol}")
        return err.max().item()

    # ------------------------------------------------------------------ #
    # Phase 1: card and set-up
    # ------------------------------------------------------------------ #
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"[1] card: {card}")
    print(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all(KERNEL_NAMES, verbose=True)
    build_s = time.perf_counter() - t0
    print(f"[1] built {len(logs)} CUDA sources in {build_s:.1f} s "
          f"into {_build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line or "warning" in line:
                print(f"[1]   {name}: {line.strip()}")

    hw = H100_SXM.as_hardware_model(dtype_bytes=4)
    specs = list(NETWORKS["resnet8"])
    plan = plan_emitable_network(specs, hw, name="resnet8")
    emitted = [emit_layer_kernel(lp) for lp in plan.layers]
    c_elems = _build.bind("conv2d_offload_planned",
                          "conv2d_offload_planned_smem_elements",
                          [ctypes.c_int] * 7, ctypes.c_longlong)
    c_simple = _build.bind("conv2d_offload", "conv2d_offload_smem_bytes",
                           [ctypes.c_int] * 6, ctypes.c_longlong)
    for em in emitted:
        s = em.spec
        if c_simple(s.c_in, s.h_k, s.w_k, s.s_w, em.t_run, 4) != \
                planner.conv_simple_smem_bytes(s, em.t_run, 4):
            fail(f"layer {em.layer_index}: the simple kernel's window in "
                 f"the CUDA source and in core.planner differ")
        in_c = c_elems(s.c_in, s.c_out, s.h_k, s.w_k, s.s_h, s.s_w, em.t_run)
        if in_c != em.vmem_elements or \
                em.vmem_elements != kernel_vmem_elements(s, em.t_run):
            fail(f"layer {em.layer_index}: the CUDA source allocates "
                 f"{in_c} elements, the planner budgets {em.vmem_elements}")
        print(f"[1] L{em.layer_index}: {s.c_in}x{s.h_in}x{s.w_in}->"
              f"{s.c_out}  t_run={em.t_run} order={em.order} "
              f"grid={em.grid_meta.grid} shared memory "
              f"{em.vmem_elements * 4} B (f32) of "
              f"{H100_SXM.smem_bytes_per_block}")

    # ------------------------------------------------------------------ #
    # Phase 2: kernels against their plain versions, on the card
    # ------------------------------------------------------------------ #
    worst = {name: 0.0 for name in KERNEL_NAMES}

    def compare(label, x, k, t_run, s_h, s_w, order, dtype_name):
        kw = dict(t_run=t_run, s_h=s_h, s_w=s_w, order=order)
        pairs = (
            ("conv2d_offload_planned", conv.conv2d_offload_planned,
             conv.conv2d_offload_planned_plain),
            ("conv2d_offload", conv.conv2d_offload,
             conv.conv2d_offload_plain))
        errs = []
        for name, kernel, plain in pairs:
            err = max_err_within(kernel(x, k, **kw), plain(x, k, **kw),
                                 dtype_name, f"{name} {label}")
            worst[name] = max(worst[name], err)
            errs.append(err)
        rtol, atol = TOL[dtype_name]
        print(f"[2] {label} {order} {dtype_name}: max abs err planned "
              f"{errs[0]:.3e} simple {errs[1]:.3e} "
              f"(rtol {rtol}, atol {atol})")

    for dtype_name, dtype in dtypes.items():
        for em in emitted:
            s = em.spec
            x, k = make_layer(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k, s.w_k,
                              dtype)
            compare(f"resnet8 L{em.layer_index} t_run={em.t_run}", x, k,
                    em.t_run, s.s_h, s.s_w, em.order, dtype_name)
            # the simple kernel also at the run length ops.conv2d picks
            t_ops = planner.plan_conv(
                s, dtype_bytes=x.element_size()).tiles["t"]
            if s.w_out % t_ops == 0 and t_ops != em.t_run:
                compare(f"resnet8 L{em.layer_index} t_run={t_ops}", x, k,
                        t_ops, s.s_h, s.s_w, "zigzag", dtype_name)
        for (c_in, h, w, n, kh, kw_, sh, sw, t_run) in GEOMETRY_CASES:
            for order in ("zigzag", "row"):
                x, k = make_layer(c_in, h, w, n, kh, kw_, dtype)
                compare(f"case {c_in}x{h}x{w}->{n} k{kh}x{kw_} "
                        f"s{sh}x{sw} t_run={t_run}", x, k, t_run, sh, sw,
                        order, dtype_name)
    print("[2] launches so far: " + json.dumps(conv.LAUNCHES))

    # ------------------------------------------------------------------ #
    # Phase 3: the main path at full width
    # ------------------------------------------------------------------ #
    for name in conv.LAUNCHES:
        conv.LAUNCHES[name] = 0
    plan = plan_emitable_network(specs, hw, name="resnet8")
    emitted = [emit_layer_kernel(lp) for lp in plan.layers]
    if len(emitted) != 7:
        fail(f"ResNet-8 has 7 conv layers, the plan has {len(emitted)}")
    calls = 0
    for dtype_name, dtype in dtypes.items():
        for em in emitted:
            s = em.spec
            errs_k1, errs_k2 = [], []
            for _ in range(INPUTS_PER_LAYER):
                x, k = make_layer(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k,
                                  s.w_k, dtype)
                want = ref.conv2d(x, k, s.s_h, s.s_w)
                if tuple(want.shape) != (s.c_out, s.h_out, s.w_out):
                    fail(f"oracle shape {tuple(want.shape)}")
                errs_k1.append(max_err_within(
                    em.run(x, k), want, dtype_name,
                    f"EmittedConv.run L{em.layer_index} {dtype_name}"))
                errs_k2.append(max_err_within(
                    ops.conv2d(x, k, s_h=s.s_h, s_w=s.s_w), want,
                    dtype_name, f"ops.conv2d L{em.layer_index} {dtype_name}"))
                calls += 1
            print(f"[3] L{em.layer_index} {dtype_name}: "
                  f"{INPUTS_PER_LAYER} inputs, max abs err vs ref.conv2d: "
                  f"EmittedConv.run {max(errs_k1):.3e}, ops.conv2d "
                  f"{max(errs_k2):.3e}")
    main_launches = dict(conv.LAUNCHES)
    print(f"[3] main path: {calls} calls of each entry point, launches "
          + json.dumps(main_launches))
    for name in KERNEL_NAMES:
        if main_launches[name] != calls:
            fail(f"the main path made {calls} calls but kernel {name} was "
                 f"launched {main_launches[name]} times")

    # ------------------------------------------------------------------ #
    # Phase 4: times
    # ------------------------------------------------------------------ #
    def time_ms(fn, *, warmup=3, batches=5, per_batch=20):
        """Median over batches of (CUDA-event time of a batch of calls) /
        (calls in the batch)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_batch):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / per_batch)
        return statistics.median(times)

    def device_ms(fns, calls=10):
        """Device time per call of each CUDA kernel of this package, by
        kernel name, from ``torch.profiler`` over ``calls`` calls of every
        function in ``fns``.  None for a kernel the trace shows no device
        time for (the profiler cannot trace the card everywhere)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        found = {name: None for name in KERNEL_NAMES}
        for ev in prof.key_averages():
            total_us = getattr(ev, "device_time_total", None)
            if total_us is None:                 # older name of the field
                total_us = getattr(ev, "cuda_time_total", 0.0)
            for name in KERNEL_NAMES:
                if f"{name}_kernel" in ev.key and total_us > 0:
                    found[name] = (found[name] or 0.0) + total_us / 1e3 / calls
        return found

    def bound(s, dtype_name, elem_bytes):
        """(ms, which): the larger of bytes over the memory rate (input,
        kernels and output once each) and 2*MACs over the peak rate."""
        moved = (s.c_in * s.h_in * s.w_in + s.kernel_elements
                 + s.c_out * s.num_patches) * elem_bytes
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * s.macs_total / PEAK_FLOPS[dtype_name] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")

    print("[4] times in ms: 'call' is the wrapper per call (median of 5 "
          "batches of 20 calls, CUDA events), 'kernel alone' the CUDA "
          f"kernel's device time per call (torch.profiler); card: {card}")
    print("[4] at these sizes bytes and operations both take far less than "
          "one launch's latency: the bound is not what limits either kernel")
    # Pass A times every layer with CUDA events; pass B then takes the
    # kernels' device times with the profiler, which stays attached once
    # it has run and would slow the host side of pass A's calls.
    layer_rows = {name: [] for name in KERNEL_NAMES}
    profiled = []
    for dtype_name, dtype in dtypes.items():
        for em in emitted:
            s = em.spec
            x, k = make_layer(s.c_in, s.h_in, s.w_in, s.c_out, s.h_k, s.w_k,
                              dtype)
            t_ops = planner.plan_conv(
                s, dtype_bytes=x.element_size()).tiles["t"]
            x_pad = F.pad(x, (0, ((-s.w_out) % t_ops) * s.s_w))
            b_ms, b_by = bound(s, dtype_name, x.element_size())

            def run_k1(em=em, x=x, k=k):
                return em.run(x, k)

            def run_k2(s=s, x=x, k=k):
                return ops.conv2d(x, k, s_h=s.s_h, s_w=s.s_w)

            def plain_k1(em=em, s=s, x=x, k=k):
                return conv.conv2d_offload_planned_plain(
                    x, k, t_run=em.t_run, s_h=s.s_h, s_w=s.s_w,
                    order=em.order)

            def plain_k2(s=s, x_pad=x_pad, k=k, t_ops=t_ops):
                return conv.conv2d_offload_plain(
                    x_pad, k, t_run=t_ops, s_h=s.s_h, s_w=s.s_w)

            lib_ms = time_ms(lambda: F.conv2d(x[None], k,
                                              stride=(s.s_h, s.s_w)))
            once = dict(warmup=1, batches=3, per_batch=1)
            timed = {
                "conv2d_offload_planned": (
                    em.t_run, time_ms(run_k1), time_ms(plain_k1, **once)),
                "conv2d_offload": (
                    t_ops, time_ms(run_k2), time_ms(plain_k2, **once)),
            }
            rows = {}
            for name, (t_run, ms, plain_ms) in timed.items():
                rows[name] = {
                    "layer": em.layer_index, "dtype": dtype_name,
                    "shape": f"{s.c_in}x{s.h_in}x{s.w_in}->{s.c_out}",
                    "t_run": t_run, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "device_ms": None}
                layer_rows[name].append(rows[name])
            profiled.append((rows, [run_k1, run_k2]))
    for rows, fns in profiled:
        dev = device_ms(fns)
        for name, r in rows.items():
            r["device_ms"] = dev[name]
            dev_txt = "not measured" if dev[name] is None \
                else f"{dev[name]:.4f}"
            print(f"[4] {name} L{r['layer']} {r['dtype']} "
                  f"t_run={r['t_run']}: call {r['ms']:.4f}  kernel alone "
                  f"{dev_txt}  plain {r['plain_ms']:.3f}  F.conv2d "
                  f"{r['library_ms']:.4f}  bound {r['bound_ms']:.6f} "
                  f"({r['bound_by']})")

    # One entry per kernel.  Its times are sums over the seven ResNet-8
    # layers in float32 (one pass of the network through that kernel);
    # the file named by --json holds every layer and dtype.
    replaces = {
        "conv2d_offload_planned":
            "src/repro/kernels/conv2d_offload.py:321",
        "conv2d_offload": "src/repro/kernels/conv2d_offload.py:183",
    }
    kernels = []
    for name in KERNEL_NAMES:
        rows = [r for r in layer_rows[name] if r["dtype"] == "float32"]
        by = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": main_launches[name],
            "max_abs_err": worst[name],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": by,
            "library_ms": sum(r["library_ms"] for r in rows),
            "device_ms": None if any(r["device_ms"] is None for r in rows)
            else sum(r["device_ms"] for r in rows),
            "times_are": "sums over the 7 ResNet-8 layers, float32"})
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(
            {"card": card, "kernels": kernels, "layers": layer_rows},
            indent=1))

    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
