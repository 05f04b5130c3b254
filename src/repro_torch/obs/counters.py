"""The port's host counters, in one registry: the launches of the
hand-written kernels and the decode step's model-level events, by name.

``kernels._build.Launcher`` adds one under its kernel's name for every
launch the kernel took (and ``kernels.flash_decode`` one to
``flash_decode_mma`` for a split launch that scores on the tensor
cores); ``models.ssm.ssd_decode`` adds one to
``ssm_update`` for every recurrent update, ``models.zamba2`` one to
``zamba2_block<k>`` for every application of block ``k`` and
``models.nemotron_h`` one to ``nemotron_moe`` for every application of
an expert layer.  The plain
PyTorch versions never count.  A CUDA graph's replay passes through none
of them, so a capture counts one step's (``launch.steps.step_counters``).
A reader takes differences of :data:`COUNTS` around the work it watches.
"""
from __future__ import annotations

COUNTS: dict[str, int] = dict.fromkeys((
    "conv2d_offload", "conv2d_offload_planned", "flash_decode",
    "flash_decode_combine", "flash_decode_mma", "block_matmul_osta",
    "block_matmul_rmw", "ssd_update_kernel", "ssm_update", "zamba2_block0",
    "zamba2_block1", "nemotron_moe"), 0)


def count(name: str) -> None:
    """Add one to ``name``'s counter, starting it at 0 if it is new."""
    COUNTS[name] = COUNTS.get(name, 0) + 1
