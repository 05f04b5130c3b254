"""Off-chip DRAM model (paper Sec 6).

Holds the full input/kernel tensors (assumed to fit, Sec 2.1) and receives
written-back output values.  Counts transferred elements so bandwidth-style
metrics can be derived."""
from __future__ import annotations

import numpy as np

from repro_torch.sim.layer import ConvLayer


class Dram:
    def __init__(self, layer: ConvLayer):
        self.layer = layer
        s = layer.spec
        # outputs start undefined; the functional check requires every value
        # to be written back exactly once.
        self.output = np.full((s.c_out, s.h_out, s.w_out), np.nan,
                              dtype=np.float32)
        self.elements_read = 0      # DRAM -> on-chip
        self.elements_written = 0   # on-chip -> DRAM

    # --- loads ----------------------------------------------------------
    def read_pixel(self, h: int, w: int) -> np.ndarray:
        """All C_in channels of a spatial pixel (Remark 6: channels move
        together)."""
        self.elements_read += self.layer.spec.c_in
        return self.layer.input[:, h, w]

    def read_kernel(self, kid: int) -> np.ndarray:
        k = self.layer.kernels[kid]
        self.elements_read += k.size
        return k

    # --- write-back -----------------------------------------------------
    def write_output(self, pid: int, values: np.ndarray) -> None:
        """All C_out channels of output position ``pid``."""
        s = self.layer.spec
        i, j = s.patch_pos(pid)
        if not np.all(np.isnan(self.output[:, i, j])):
            raise RuntimeError(f"output {pid} written twice")
        self.output[:, i, j] = values
        self.elements_written += values.size
