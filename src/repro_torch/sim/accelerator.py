"""Accelerator model: on-chip memory + processing element (paper Sec 6).

The on-chip memory stores *values* keyed by the same identifiers the
formalism uses (spatial pixel ids, kernel ids, output position ids), so a
formal ``Step`` drives the functional simulation directly.  Capacity is
checked in tensor elements at every point of the step sequence."""
from __future__ import annotations

import numpy as np

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.cost_model import HardwareModel


class OnChipMemory:
    def __init__(self, spec: ConvSpec, capacity: int | None):
        self.spec = spec
        self.capacity = capacity
        self.pixels: dict[int, np.ndarray] = {}    # pixel id -> (C_in,)
        self.kernels: dict[int, np.ndarray] = {}   # kernel id -> (C_in,Hk,Wk)
        self.outputs: dict[int, np.ndarray] = {}   # patch id -> (C_out,)

    # --- occupancy in tensor elements ------------------------------------
    @property
    def used(self) -> int:
        s = self.spec
        return (len(self.pixels) * s.c_in
                + len(self.kernels) * s.c_in * s.h_k * s.w_k
                + len(self.outputs) * s.c_out)

    def check_capacity(self) -> None:
        if self.capacity is not None and self.used > self.capacity:
            raise MemoryError(
                f"on-chip memory overflow: {self.used} > {self.capacity}")

    # --- set-like mutations ----------------------------------------------
    def free_pixels(self, ids) -> None:
        for j in ids:
            del self.pixels[j]

    def free_kernels(self, ids) -> None:
        for k in ids:
            del self.kernels[k]

    def pop_outputs(self, ids) -> dict[int, np.ndarray]:
        return {p: self.outputs.pop(p) for p in ids}

    def store_pixel(self, j: int, v: np.ndarray) -> None:
        if j in self.pixels:
            raise RuntimeError(f"pixel {j} reloaded while resident")
        self.pixels[j] = v

    def store_kernel(self, k: int, v: np.ndarray) -> None:
        self.kernels[k] = v


class Accelerator:
    """PE + on-chip memory.  ``compute(group)`` realises action a6."""

    def __init__(self, spec: ConvSpec, hw: HardwareModel):
        self.spec = spec
        self.hw = hw
        self.mem = OnChipMemory(spec, hw.size_mem)
        self.total_macs = 0

    def compute(self, group) -> None:
        s = self.spec
        macs = len(group) * s.nb_op_value * s.c_out
        if macs > self.hw.nbop_pe:
            raise RuntimeError(
                f"PE overrun: step needs {macs} MACs > {self.hw.nbop_pe}")
        if len(self.mem.kernels) != s.n_kernels:
            raise RuntimeError("S1 compute requires all kernels resident")
        kern = np.stack([self.mem.kernels[k] for k in range(s.n_kernels)])
        for pid in group:
            h0, w0, h1, w1 = s.patch_bbox(pid)
            patch = np.empty((s.c_in, s.h_k, s.w_k), dtype=np.float32)
            for h in range(h0, h1):
                for w in range(w0, w1):
                    j = s.pixel_id(h, w)
                    if j not in self.mem.pixels:
                        raise RuntimeError(
                            f"patch {pid} needs pixel {j} not on-chip")
                    patch[:, h - h0, w - w0] = self.mem.pixels[j]
            # (N, C_in, Hk, Wk) . (C_in, Hk, Wk) -> (N,)
            self.mem.outputs[pid] = np.einsum(
                "nchw,chw->n", kern, patch).astype(np.float32)
        self.total_macs += macs
