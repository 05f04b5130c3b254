"""Convolution slicing (paper Sec 3, Defs 4-11).

A 2D convolution takes a 3D input ``(C_in, H_in, W_in)`` and N kernels
``(C_in, H_K, W_K)`` and produces ``(N, H_out, W_out)``.  The *patch*
``P_{i,j}`` is the input slice needed to compute output column ``O[:, i, j]``.

Per the paper's Remark 6 we work with 2-D *spatial* pixels — the channel
dimension is never sliced, so a spatial pixel stands for all its C_in channel
elements.  Per Remark 2 the input is assumed already padded.

Patches and pixels are linearised row-major (Remarks 4-5).  Pixel sets are
represented as Python int bitmasks over the H_in*W_in spatial grid: set ops
are then single integer ops and cardinality is ``int.bit_count()`` — this is
what makes the ILP polishing search and the simulator fast.
"""
from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """A convolution layer (already-padded input)."""

    c_in: int
    h_in: int
    w_in: int
    n_kernels: int          # N == C_out
    h_k: int
    w_k: int
    s_h: int = 1
    s_w: int = 1

    def __post_init__(self):
        if self.h_out < 1 or self.w_out < 1:
            raise ValueError(f"kernel larger than input: {self}")

    # --- Def 8 ------------------------------------------------------------
    @property
    def c_out(self) -> int:
        return self.n_kernels

    @property
    def h_out(self) -> int:
        return (self.h_in - self.h_k) // self.s_h + 1

    @property
    def w_out(self) -> int:
        return (self.w_in - self.w_k) // self.s_w + 1

    @property
    def num_patches(self) -> int:
        """|X| = H_out * W_out (Def 11)."""
        return self.h_out * self.w_out

    @property
    def num_pixels(self) -> int:
        """Spatial pixels of the input grid (Remark 6: channel collapsed)."""
        return self.h_in * self.w_in

    # --- Def 13 -----------------------------------------------------------
    @property
    def nb_op_value(self) -> int:
        """MACs to compute one output value."""
        return self.c_in * self.h_k * self.w_k

    @property
    def macs_total(self) -> int:
        return self.nb_op_value * self.c_out * self.num_patches

    # --- sizes in tensor elements (for memory-footprint accounting) -------
    @property
    def kernel_elements(self) -> int:
        """All kernels: C_out * C_in * H_K * W_K (term 2 of eq. 12)."""
        return self.c_out * self.c_in * self.h_k * self.w_k

    # --- linearisation (Remarks 4-5) ---------------------------------------
    def patch_id(self, i: int, j: int) -> int:
        """Row-major patch index for output position (i, j)."""
        return i * self.w_out + j

    def patch_pos(self, pid: int) -> tuple[int, int]:
        return divmod(pid, self.w_out)

    def pixel_id(self, h: int, w: int) -> int:
        """Row-major spatial pixel index."""
        return h * self.w_in + w

    def pixel_pos(self, jid: int) -> tuple[int, int]:
        return divmod(jid, self.w_in)

    # --- Def 10: patches as pixel bitmasks ---------------------------------
    def patch_bbox(self, pid: int) -> tuple[int, int, int, int]:
        """(h0, w0, h1, w1) half-open input window of patch ``pid``."""
        i, j = self.patch_pos(pid)
        h0, w0 = i * self.s_h, j * self.s_w
        return h0, w0, h0 + self.h_k, w0 + self.w_k

    @functools.cached_property
    def patch_masks(self) -> tuple[int, ...]:
        """Bitmask of spatial pixels for every patch, indexed by patch id."""
        masks = []
        for pid in range(self.num_patches):
            h0, w0, h1, w1 = self.patch_bbox(pid)
            m = 0
            for h in range(h0, h1):
                row = ((1 << (w1 - w0)) - 1) << (h * self.w_in + w0)
                m |= row
            masks.append(m)
        return tuple(masks)

    @functools.cached_property
    def all_pixels_mask(self) -> int:
        """Union of all patches — pixels that are ever needed."""
        m = 0
        for pm in self.patch_masks:
            m |= pm
        return m

    def group_mask(self, patch_ids) -> int:
        """Pixel bitmask of a patch group (union of its patches)."""
        m = 0
        masks = self.patch_masks
        for pid in patch_ids:
            m |= masks[pid]
        return m

    # --- pxl_in_P constant of Sec 5.1 --------------------------------------
    @functools.cached_property
    def pxl_in_p(self) -> frozenset[tuple[int, int]]:  # lint: public-api
        """{(patch_id, pixel_id) | pixel in patch} (Example 3)."""
        pairs = []
        for pid, m in enumerate(self.patch_masks):
            jid = 0
            mm = m
            while mm:
                low = mm & -mm
                pairs.append((pid, low.bit_length() - 1))
                mm ^= low
        return frozenset(pairs)

    def pixels_of_mask(self, mask: int) -> list[int]:
        """Sorted pixel ids present in a bitmask."""
        out = []
        while mask:
            low = mask & -mask
            out.append(low.bit_length() - 1)
            mask ^= low
        return out
