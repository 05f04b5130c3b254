"""Fault-tolerant checkpointing, on the JAX package's on-disk layout.

  * **layout** — ``step_N/host_<id>.npz`` (one array per leaf, keyed by
    its ``/``-joined tree path, e.g. ``params/layers/attn/wq``),
    ``step_N/manifest.json`` (step, time, extra, host, and each leaf's
    dtype) and ``step_N/COMMIT``;
  * **atomic commit** — writes go to ``step_N.tmp/``, ``COMMIT`` is
    written last and fsync'd, then one ``rename`` publishes ``step_N/``;
    readers trust only directories with a ``COMMIT`` marker, so a crash
    mid-write never corrupts the restore source;
  * **async save** — ``save`` copies every tensor from the device to the
    host before it returns (the next train step updates the parameters in
    place, so a writer thread reading live tensors would race), then a
    background thread writes the files; its error surfaces on the next
    ``wait()``;
  * **restore** into the structure of ``like``, onto its devices (the
    caller's);
  * **retention** — the newest ``keep`` committed checkpoints.

numpy has no bfloat16: a bfloat16 tensor is stored as its 2-byte bit
patterns with the numpy dtype ``|V2``, which is what ``np.asarray`` of the
JAX package's ``ml_dtypes.bfloat16`` arrays gives and ``np.savez``
writes; the manifest records ``bfloat16``, and a ``|V2`` array of a
manifest without dtypes (the JAX package's) is read as bfloat16 too.  A
checkpoint that the JAX package's ``CheckpointManager`` wrote restores
here bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

_BF16_BITS = np.dtype("V2")


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``/``-joined tree paths -> leaves, the JAX package's keys."""
    if isinstance(tree, dict):
        flat = {}
        for name in sorted(tree):
            flat.update(_flatten(tree[name], f"{prefix}{name}/"))
        return flat
    return {prefix[:-1]: tree}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy for a CPU tensor too: the writer
    thread must not read a tensor the next step updates in place)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    if dtype == "bfloat16" or (dtype is None and arr.dtype == _BF16_BITS):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_into(like, flat: dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, dict):
        return {name: _unflatten_into(sub, flat, f"{prefix}{name}/")
                for name, sub in like.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    t = flat[key]
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 host_id: int = 0, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------
    def save(self, step: int, state: Any, extra: dict | None = None,
             block: bool = False) -> None:
        """Snapshot ``state`` (a tree of dicts of tensors) at ``step``."""
        self.wait()                      # one in-flight save at a time
        leaves = _flatten(state)
        host_arrays = {k: _to_host(t) for k, t in leaves.items()}
        meta = {"step": step, "time": time.time(), "extra": extra or {},
                "host": self.host_id,
                "dtypes": {k: str(t.dtype).removeprefix("torch.")
                           for k, t in leaves.items()}}

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, f"host_{self.host_id}.npz"),
                         **host_arrays)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(meta, f)
                with open(os.path.join(tmp, "COMMIT"), "w") as f:
                    f.write(str(step))
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except Exception as e:          # surfaced on the next wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.committed_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------- restore ----------------
    def committed_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        """Load ``step`` into the structure, shapes, dtypes and devices of
        ``like`` (a tree of tensors on the caller's device).  Returns
        (state, manifest)."""
        path = os.path.join(self.dir, f"step_{step}")
        if not os.path.exists(os.path.join(path, "COMMIT")):
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        with np.load(os.path.join(path, f"host_{self.host_id}.npz")) as z:
            flat = {k: _from_host(z[k], dtypes.get(k)) for k in z.files}
        return _unflatten_into(like, flat), meta

    def restore_latest(self, like: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, like)
