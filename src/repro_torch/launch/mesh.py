"""Mesh builders: the JAX package's production and smoke meshes as
``torch.distributed`` ``DeviceMesh``es over the default process group.

``make_production_mesh`` is a FUNCTION, so importing this module touches
no process group.  Single pod: (data=16, model=16) = 256 ranks.
Multi-pod: a leading pure-DP "pod" axis (2 pods = 512 ranks), the lowest
pressure on the slower links between pods.  ``make_smoke_mesh`` lays
whatever ranks the group has out as (data, model); on one card that is
(1, 1), which shards nothing.

:func:`init_process_group` makes the default group when none is: NCCL on
the card, gloo on the CPU, from ``torchrun``'s environment when it set
one, else a one-rank group over an in-process store (no port and no
network).  The dry run (``launch/dryrun.py``) makes its own fake group of
256 or 512 ranks.

The JAX package's ``as_shardings`` (PartitionSpec trees wrapped into
``NamedSharding``s for its jit) has no job here: nothing is jitted with
in/out shardings, and ``models.common.placements`` turns a spec into
DTensor placements where a tensor is laid out.  Its
``supports_ambient_partition_specs`` goes with it.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.models.layers import ambient_mesh

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def _launched() -> bool:
    """Whether ``torchrun`` (or a launcher like it) set this process's
    rank in the environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def card_index(device: str | torch.device = "cuda") -> int:
    """The card this process binds to: under ``torchrun`` its
    ``LOCAL_RANK`` (one card per process of a host), else ``device``'s
    index (0 when it names none)."""
    if _launched() and "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return torch.device(device).index or 0


def init_process_group(device: str | torch.device = "cuda") -> None:
    """The default process group, made if there is none: NCCL for a CUDA
    ``device`` (the card :func:`card_index` names, made current), gloo
    otherwise; over ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) when it is set, else one rank over a
    ``dist.HashStore`` in this process."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(card_index(dev))
    if _launched():
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _device_type() -> str:
    """The device type of the default group's ranks: "cuda" under NCCL,
    "cpu" under gloo or the dry run's fake backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, over the default group, which must have exactly that
    many ranks (256 or 512)."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs a process "
            f"group of {need} ranks, and the default group has {have}; "
            f"launch {need} ranks, or use make_smoke_mesh() on what there is")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_smoke_mesh(devices: int | None = None):
    """A (data, model) mesh over the default group's ranks: (n // 2, 2)
    for n > 1 ranks, (1, 1) for one."""
    n = devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a smoke mesh of {n} ranks over a group of "
                         f"{dist.get_world_size()}")
    d = max(1, n // 2) if n > 1 else 1
    return init_device_mesh(_device_type(), (d, n // d),
                            mesh_dim_names=("data", "model"))


def launch_mesh(device: str | torch.device, multi_pod: bool = False):
    """The mesh of a ``--full`` launch (the train and serve drivers):
    the default group made if there is none, then the production mesh
    when ``multi_pod`` is asked for or the group has the single pod's 256
    ranks, else the smoke mesh over the ranks there are."""
    init_process_group(device)
    if multi_pod or dist.get_world_size() == math.prod(SINGLE_POD):
        return make_production_mesh(multi_pod=multi_pod)
    return make_smoke_mesh()


def enter_mesh(mesh):
    """Context manager making ``mesh`` the ambient mesh: the one
    ``layers.shard`` pins activations to, and the step functions of
    ``launch.steps`` distribute over."""
    return ambient_mesh(mesh)
