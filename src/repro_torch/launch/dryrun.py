"""Multi-pod dry run: every (architecture x input shape) step on the
production meshes, without the devices, and its per-device statistics.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
        --shape train_4k [--multi-pod] [--out benchmarks/results/dryrun_torch]

It owns its process, as the JAX package's does through ``XLA_FLAGS``: it
starts a FAKE process group of 256 (512 with ``--multi-pod``) ranks
(``FakeStore``, backend ``"fake"``: collectives return at once and move
nothing), builds the production mesh over it, and lays params, optimizer
state, inputs and cache out as DTensors of fake tensors by the specs, so
nothing of the published size is allocated.  Its "devices" are
placeholders, as the reference's are: this is the one entry point that
runs without a card.  It then runs the cell's step (``launch.steps``'
``dist_train_step``: forward, backward, AdamW; ``dist_prefill_step``;
``dist_decode_step``) for real on those fake shards, under
``hlo_stats.count`` (rank 0's local operations and collectives) and a
tracker of rank 0's live tensors (:class:`_PeakTracker`).

Per cell it writes a JSON with the reference's keys:
  * ``memory``: ``argument_bytes``, one device's shards of every
    argument, each split dim rounded up as XLA pads it; ``output_bytes``
    and ``alias_bytes`` (outputs written in place into an argument, XLA's
    donation) likewise; ``peak_device_bytes`` the peak of the bytes of
    the device's live tensors, arguments included; ``temp_bytes`` what the peak holds beyond the
    arguments and the fresh outputs; ``code_bytes`` 0 (no compiled code);
  * ``analyzed``: ``hlo_stats.count``'s per-device statistics, the
    microbatch loop multiplied by its trips; ``cost`` and
    ``collectives_per_device_bytes_raw`` the same with that loop counted
    once (the reference's raw XLA numbers count loop bodies once);
  * ``lower_s`` the whole fake run, ``compile_s`` 0 (nothing compiles),
    ``hlo_bytes`` 0 (there is no HLO);
  * for a cell ``cell_applicable`` refuses, the ``skipped`` record.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch import hlo_stats, steps
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, enter_mesh,
                                     make_production_mesh)
from repro_torch.models import registry
from repro_torch.models.common import (SHAPES, Axes, cell_applicable, leaves,
                                       local_shape, map_trees, placements)
from repro_torch.optim import adamw


class _PeakTracker(TorchDispatchMode):
    """The peak of the bytes held by live tensor storages on this rank:
    those passed to :meth:`track`, and every output of an operation on
    the local shards (DTensor's own shape inference, under a fake mode of
    its own, allocates nothing and is left out, as in ``hlo_stats``).  A
    storage counts from its first sight until it is freed."""

    def __init__(self):
        super().__init__()
        self._entry = active_fake_mode()
        self._live: dict[int, weakref.ref] = {}
        self.now = self.peak = 0

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self.now += n
        self.peak = max(self.peak, self.now)
        self._live[key] = weakref.ref(
            st, lambda _, key=key, n=n: self._free(key, n))

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.now -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if active_fake_mode() is self._entry:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.track(t)
        return out


def _fake_dtensors(tree, specs, mesh, fake_mode):
    """``meta`` tensors -> DTensors on ``mesh`` whose local shards (this
    rank's) are fake tensors of the shard's shape."""
    def one(meta, spec):
        pl = placements(spec, mesh)
        shape, _ = compute_local_shape_and_global_offset(meta.shape, mesh,
                                                         pl)
        with fake_mode:
            local = torch.empty(shape, dtype=meta.dtype)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=meta.shape, stride=meta.stride())

    return map_trees(one, tree, specs)


def _padded_bytes(tree, specs, mesh_shape: dict) -> int:
    """One device's bytes of ``tree`` laid out by ``specs``, every split
    dim rounded up (XLA's padded shards)."""
    return sum(math.prod(local_shape(t.shape, s, mesh_shape))
               * t.element_size()
               for t, s in zip(leaves(tree), leaves(specs), strict=True))


def _cell_args(api, cell, axes, mesh, fake_mode):
    """(step, args, argument specs) of one cell, the args fake DTensors."""
    if cell.kind == "train":
        params, opt, inputs = steps.abstract_train_args(api, cell, axes)
        _, bspecs = api.input_specs(cell, axes)
        specs = (api.param_specs(axes),
                 adamw.state_specs(api.zero1_specs(axes), axes), bspecs)
        step = steps.dist_train_step(api, axes)
        args = (params, opt, inputs)
    elif cell.kind == "prefill":
        params, inputs = steps.abstract_serve_args(api, cell, axes)
        _, bspecs = api.input_specs(cell, axes)
        specs = (api.param_specs(axes), bspecs)
        step = steps.dist_prefill_step(api, axes, max_len=cell.seq_len)
        args = (params, inputs)
    else:
        params, cache, tokens, pos = steps.abstract_serve_args(api, cell,
                                                               axes)
        _, ispecs = api.input_specs(cell, axes)
        specs = (api.param_specs(axes, layout="decode"), ispecs["cache"],
                 ispecs["tokens"], ispecs["pos"])
        step = steps.dist_decode_step(api, axes)
        args = (params, cache, tokens, pos)
    args = tuple(_fake_dtensors(a, s, mesh, fake_mode)
                 for a, s in zip(args, specs, strict=True))
    return step, args, specs


def _local_bytes(tensors) -> int:
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in tensors)


def _storages(tensors) -> set:
    return {(t.to_local() if isinstance(t, DTensor) else t)
            .untyped_storage()._cdata for t in tensors}


def _collectives(st: hlo_stats.Stats) -> dict:
    out = dict(st.collective_bytes)
    out["count"] = st.collective_count
    out["total"] = st.collective_total
    return out


def lower_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """Run one cell on the fake production mesh; the caller's process has
    no process group yet, and this one makes the fake group."""
    api = registry.get(arch)
    cell = SHAPES[shape]
    ok, why = cell_applicable(api.cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group: "
                           "run it in a process of its own (python -m "
                           "repro_torch.launch.dryrun)")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(MULTI_POD if multi_pod else SINGLE_POD)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod)
        axes = Axes.for_mesh(mesh)
        mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        with enter_mesh(mesh):
            step, args, specs = _cell_args(api, cell, axes, mesh, fake_mode)
            arg_tensors = [t for a in args for t in leaves(a)]
            tracker = _PeakTracker()
            for t in arg_tensors:
                tracker.track(t.to_local())
            with tracker:
                out, stats, ran = hlo_stats.count(step, *args)
            peak = tracker.peak
        lower_s = time.perf_counter() - t0
        out_tensors = [t for o in out for t in leaves(o)
                       if isinstance(t, torch.Tensor)]
        arg_storages = _storages(arg_tensors)
        aliased = [t for t in out_tensors
                   if _storages([t]) <= arg_storages]
        argument_bytes = sum(_padded_bytes(a, s, mesh_shape)
                             for a, s in zip(args, specs, strict=True))
        output_bytes = _local_bytes(out_tensors)
        alias_bytes = _local_bytes(aliased)
    finally:
        dist.destroy_process_group()
    return {
        "arch": arch, "shape": shape,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "chips": world,
        "multi_pod": multi_pod,
        "status": "ok",
        "kind": cell.kind,
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "lower_s": round(lower_s, 1),
        "compile_s": 0.0,
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": max(0, peak - argument_bytes - output_bytes
                              + alias_bytes),
            "code_bytes": 0,
            "alias_bytes": alias_bytes,
            "peak_device_bytes": peak,
        },
        "cost": {
            "flops_per_device_raw": ran.flops,
            "bytes_accessed_per_device_raw": ran.bytes_accessed,
        },
        "analyzed": {
            "matmul_flops_per_device": stats.flops,
            "bytes_accessed_per_device": stats.bytes_accessed,
            "collective_bytes_per_device": stats.collective_bytes,
            "collective_bytes_total": stats.collective_total,
            "collective_count": stats.collective_count,
            "unknown_trip_loops": stats.unknown_trip_loops,
        },
        "collectives_per_device_bytes_raw": _collectives(ran),
        "hlo_bytes": 0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--shape", required=True, choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="benchmarks/results/dryrun_torch")
    args = ap.parse_args(argv)

    result = lower_cell(args.arch, args.shape, args.multi_pod)
    mesh_tag = "pod" if args.multi_pod else "single"
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{args.arch}_{args.shape}_{mesh_tag}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("memory", "cost")}, indent=1))
    if result["status"] == "ok":
        print("memory_analysis:", json.dumps(result["memory"]))
        print("cost_analysis:", json.dumps(result["cost"]))
    print("saved ->", path)
    return 0 if result["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
