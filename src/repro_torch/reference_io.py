"""What carries weights and solved plans from the JAX package across.

The port imports nothing of the JAX package, so everything crosses as
numpy arrays, plain integers and strings: a test (or a user with arrays
on disk) hands the same inputs and the same solved plan to both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.conv_spec import ConvSpec
from repro_torch.core.strategies import GridMeta
from repro_torch.kernels import KernelShapeError
from repro_torch.kernels.emit import EmittedConv, kernel_vmem_elements


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device to make tensors on: the card unless the caller names the
    CPU.  Asking for a card that is absent raises; nothing lands on the
    CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} was asked for but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present")
    return dev


def layer_from_numpy(x: np.ndarray, w: np.ndarray, *,
                     device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.float32
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's arrays as the reference holds them — ``x (C_in, H_in,
    W_in)``, ``w (N, C_in, H_K, W_K)`` — as contiguous tensors of the
    port, of ``dtype``, on ``device``."""
    x = np.asarray(x)
    w = np.asarray(w)
    if x.ndim != 3 or w.ndim != 4:
        raise KernelShapeError(
            f"want x (C_in, H_in, W_in) and w (N, C_in, H_K, W_K), got "
            f"{x.shape} and {w.shape}")
    dev = resolve_device(device)

    def to_tensor(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return t.to(device=dev, dtype=dtype).contiguous()

    return to_tensor(x), to_tensor(w)


def emitted_from_fields(spec_fields: dict, t_run: int, order: str,
                        layer_index: int) -> EmittedConv:
    """Rebuild an :class:`EmittedConv` of the port from the plain fields
    of a reference one: ``spec_fields`` is ``dataclasses.asdict`` of its
    ``ConvSpec`` (integers), ``t_run`` / ``order`` / ``layer_index`` its
    grid.  The shared-memory occupancy is the port's own."""
    spec = ConvSpec(**{k: int(v) for k, v in spec_fields.items()})
    if order not in ("zigzag", "row"):
        raise KernelShapeError(f"unknown grid order {order!r}")
    if t_run <= 0 or spec.w_out % t_run:
        raise KernelShapeError(
            f"t_run={t_run} must divide w_out={spec.w_out}")
    meta = GridMeta(order=order, t_run=int(t_run), h_out=spec.h_out,
                    w_out_tiles=spec.w_out // t_run)
    return EmittedConv(spec=spec, grid_meta=meta, layer_index=layer_index,
                       vmem_elements=kernel_vmem_elements(spec, t_run))
