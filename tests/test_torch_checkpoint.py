"""The port's ``CheckpointManager`` on the JAX package's on-disk layout:
the JAX package's own checkpoint cases (``tests/test_substrates.py``),
mirrored; bfloat16 leaves stored as their bits and restored exactly; the
writer thread's error surfacing on the next ``wait``; restore onto the
caller's device; and a checkpoint that the JAX package's manager wrote,
restored by the port into the tensors ``params_from_numpy`` gives."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.models import registry as jregistry
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.models import registry
from repro_torch.models.common import leaves
from repro_torch.optim import adamw
from repro_torch.reference_io import params_from_numpy


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=gen),
            "opt": {"m": torch.ones((8, 4)),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    mgr.save(10, st, extra={"loss": 1.5})
    got, meta = mgr.restore(10, st)
    assert torch.equal(got["w"], st["w"])
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 3
    assert meta["extra"]["loss"] == 1.5


def test_checkpoint_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    mgr.wait()
    assert mgr.committed_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_uncommitted_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, _state())
    os.makedirs(tmp_path / "step_9")          # a crashed half-write
    assert mgr.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        mgr.restore(9, _state())


def test_checkpoint_layout_is_the_references(tmp_path):
    """``step_N/host_0.npz`` keyed by ``/``-joined tree paths, a manifest
    with each leaf's dtype, ``COMMIT`` holding the step; no ``.tmp`` left."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, {"params": {"w": torch.ones(2, dtype=torch.bfloat16)},
                 "step": torch.tensor(7, dtype=torch.int32)})
    assert sorted(os.listdir(tmp_path)) == ["step_7"]
    assert sorted(os.listdir(tmp_path / "step_7")) == [
        "COMMIT", "host_0.npz", "manifest.json"]
    assert (tmp_path / "step_7" / "COMMIT").read_text() == "7"
    with np.load(tmp_path / "step_7" / "host_0.npz") as z:
        assert sorted(z.files) == ["params/w", "step"]
        assert z["params/w"].dtype == np.dtype("V2")
    meta = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert meta["dtypes"] == {"params/w": "bfloat16", "step": "int32"}
    assert meta["step"] == 7 and meta["host"] == 0


def test_bfloat16_leaves_restore_bit_for_bit(tmp_path):
    """Weights, float32 moments and the step of an optimizer state: every
    leaf comes back with its dtype and bits."""
    api = registry.get_reduced("zamba2-2.7b")
    params = api.init_params(2, device="cpu")
    state = {"params": params, "opt": adamw.init(params)}
    state["opt"]["m"]["embed"].normal_()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, state)
    mgr.wait()
    like = {"params": api.init_params(9, device="cpu"),
            "opt": adamw.init(params)}
    got, meta = mgr.restore(3, like)
    assert meta["step"] == 3
    for a, b in zip(leaves(got), leaves(state), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_save_copies_to_the_host_before_it_returns(tmp_path):
    """The writer thread writes what the state held at ``save``: a step
    that updates the tensors in place right after does not reach it."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    st = _state()
    want = st["w"].clone()
    mgr.save(1, st)
    st["w"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(1, _state())
    assert torch.equal(got["w"], want)


def test_a_failed_async_write_surfaces_on_the_next_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    os.makedirs(tmp_path / "step_2.tmp" / "host_0.npz")   # a directory
    mgr.save(2, _state())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                  # raised once
    assert mgr.latest_step() is None


def test_restore_refuses_another_shape(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state())
    like = _state()
    like["w"] = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, like)
    like = _state()
    del like["opt"]["m"]
    like["opt"]["x"] = torch.zeros(1)
    with pytest.raises(KeyError, match="opt/x"):
        mgr.restore(1, like)


def test_restore_onto_the_callers_device(tmp_path):
    """Each leaf lands on the device and in the dtype of ``like``'s."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    mgr.save(1, st)
    got, _ = mgr.restore(1, st)
    assert {t.device.type for t in leaves(got)} == {"cpu"}
    like = _state()
    like["w"] = like["w"].double()
    got, _ = mgr.restore(1, like)
    assert got["w"].dtype == torch.float64
    assert torch.equal(got["w"], st["w"].double())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b",
                                  "whisper-medium"])
def test_restores_a_checkpoint_the_jax_package_wrote(tmp_path, arch):
    """The JAX package's ``CheckpointManager`` saves its parameters (bf16
    leaves as ``|V2``, the MoE router and SSM leaves float32) and an int32
    step; the port restores them into its own tree and gets exactly the
    tensors ``params_from_numpy`` makes of the same arrays."""
    japi = jregistry.get_reduced(arch)
    api = registry.get_reduced(arch)
    jparams = japi.init_params(jax.random.key(4))
    JManager(str(tmp_path), async_save=False).save(
        6, {"params": jparams, "step": jnp.int32(6)})
    like = {"params": api.init_params(0, device="cpu"),
            "step": torch.zeros((), dtype=torch.int32)}
    got, meta = CheckpointManager(str(tmp_path)).restore_latest(like)
    want = params_from_numpy(jax.tree.map(np.asarray, jparams), api.cfg,
                             device="cpu")
    assert meta["step"] == 6 and int(got["step"]) == 6
    for a, b in zip(leaves(got["params"]), leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
