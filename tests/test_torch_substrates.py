"""The cases of ``tests/test_substrates.py``, read on ``repro_torch`` with
the same inputs and settings. The reference's ``jax.random`` state is
made here from an explicit seeded ``torch.Generator``, and its elastic
restore, which takes ``SingleDeviceSharding``s, is checked by where the
restored tensors lie: the port restores onto the devices of the tree it
is given. The reference's docstring follows.

Substrate tests: data pipeline determinism/elasticity, checkpoint
atomicity + elastic restore, fault-tolerance runtime, gradient compression,
optimizer.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticLM
from repro_torch.optim import adamw
from repro_torch.optim.compression import ErrorFeedbackInt8, RandomK
from repro_torch.runtime import fault_tolerance as ft
from _torch_port import fast_polish_port  # noqa: F401


# ------------------------------ data ---------------------------------- #

def test_pipeline_deterministic_across_restarts():
    src = SyntheticLM(vocab=1000, seed=7)
    cfg = DataConfig(global_batch=8, seq_len=64, data_shards=2)
    p1 = Pipeline(src, cfg, shard=0)
    batches = [p1.next() for _ in range(3)]
    p2 = Pipeline(src, cfg, shard=0)
    p2.restore({"step": 2, "shard": 0})
    np.testing.assert_array_equal(p2.next()["tokens"],
                                  batches[2]["tokens"])


def test_pipeline_shards_disjoint():
    src = SyntheticLM(vocab=1000)
    cfg = DataConfig(global_batch=8, seq_len=32, data_shards=4)
    rows = [Pipeline(src, cfg, shard=s).next()["tokens"]
            for s in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(rows[i], rows[j])


def test_pipeline_elastic_rescale_exactly_once():
    """Rescaling 4 shards -> 2 shards at step k: the union of rows consumed
    per step is a pure function of (step, nshards), so no step is ever
    double-consumed after a rescale."""
    src = SyntheticLM(vocab=100, seed=3)
    cfg4 = DataConfig(global_batch=8, seq_len=16, data_shards=4)
    cfg2 = DataConfig(global_batch=8, seq_len=16, data_shards=2)
    a = Pipeline(src, cfg2, shard=0)
    a.restore({"step": 5, "shard": 0}, new_shard=0, new_nshards=2)
    b = Pipeline(src, cfg2, shard=0, start_step=5)
    np.testing.assert_array_equal(a.next()["tokens"], b.next()["tokens"])


def test_labels_are_shifted_tokens():
    src = SyntheticLM(vocab=50)
    p = Pipeline(src, DataConfig(global_batch=2, seq_len=16))
    b = p.next()
    assert b["tokens"].shape == b["labels"].shape == (2, 16)


# --------------------------- checkpoint -------------------------------- #

def _state(seed=0):
    k = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=k),
            "opt": {"m": torch.ones((8, 4)),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    mgr.save(10, st, extra={"loss": 1.5})
    got, meta = mgr.restore(10, st)
    np.testing.assert_allclose(got["w"], st["w"])
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
    # a crashed half-write: directory without COMMIT
    os.makedirs(tmp_path / "step_9")
    assert mgr.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        mgr.restore(9, _state())


def test_checkpoint_elastic_reshard(tmp_path):
    """Restore with explicit shardings (the elastic path)."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    mgr.save(1, st)
    dev = torch.device("cpu")
    like = {"w": st["w"].to(dev),
            "opt": {k: v.to(dev) for k, v in st["opt"].items()}}
    got, _ = mgr.restore(1, like)
    assert got["w"].device == dev
    assert all(v.device == dev for v in got["opt"].values())
    torch.testing.assert_close(got["w"], st["w"], rtol=0, atol=0)


# ------------------------- fault tolerance ----------------------------- #

def test_heartbeat_detects_dead_host():
    t = [0.0]
    hb = ft.HeartbeatTracker([0, 1, 2], timeout_s=10, clock=lambda: t[0])
    t[0] = 5.0
    hb.beat(0, 1)
    hb.beat(1, 1)
    t[0] = 12.0
    assert hb.dead_hosts() == [2]
    assert hb.alive_hosts() == [0, 1]


def test_straggler_detection():
    sd = ft.StragglerDetector([0, 1, 2, 3], warmup=2)
    for _ in range(5):
        for h in (0, 1, 2):
            sd.record(h, 1.0)
        sd.record(3, 3.0)
    assert sd.stragglers() == [3]


def test_plan_rescale_power_of_two():
    plan = ft.plan_rescale(range(64), model_shards=16, chips_per_host=4)
    assert plan.data_shards == 16 and plan.world == 256
    plan2 = ft.plan_rescale(range(60), model_shards=16, chips_per_host=4)
    assert plan2.data_shards == 8            # 240 chips -> 8x16=128 used
    assert plan2.world <= 240


def test_supervisor_restart_loop(tmp_path):
    """Kill a host mid-run: supervisor replans the mesh, restores the last
    checkpoint, and completes all steps with a smaller data axis."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    sup = ft.TrainSupervisor(hosts=list(range(8)), model_shards=4,
                             checkpoint_every=5, chips_per_host=4)
    state = {"ckpt_step": 0}
    failures = {"armed": True}

    def run_step(step, plan):
        if step == 7 and failures["armed"]:
            failures["armed"] = False
            raise ft.HostFailure(3)
        return 1.0

    def save(step):
        state["ckpt_step"] = step

    def restore():
        return state["ckpt_step"]

    rep = sup.run(20, run_step, save, restore)
    assert rep.steps_done == 20
    assert rep.restarts == 1
    assert rep.rescales and rep.rescales[0] <= 8


# -------------------------- compression -------------------------------- #

def test_int8_error_feedback_converges():
    """Quantised-gradient SGD with error feedback reaches the same optimum
    on a quadratic as exact SGD (residual carries the rounding error)."""
    comp = ErrorFeedbackInt8()
    w = torch.tensor([2.0, -3.0, 1.5])
    target = torch.tensor([0.5, 0.25, -1.0])
    state = comp.init({"w": w})
    for _ in range(200):
        g = {"w": 2 * (w - target)}
        q, state = comp.compress(g, state)
        ghat = comp.decompress(q)
        w = w - 0.05 * ghat["w"]
    np.testing.assert_allclose(w, target, atol=1e-2)


def test_int8_quantisation_bounded_error():
    comp = ErrorFeedbackInt8()
    g = {"a": torch.linspace(-5, 5, 1000)}
    q, _ = comp.compress(g, comp.init(g))
    back = comp.decompress(q)
    assert float(torch.max(torch.abs(back["a"] - g["a"]))) <= 5 / 127 + 1e-6


def test_randomk_mass_conserving():
    """Error feedback conserves gradient mass: transmitted + residual ==
    accumulated gradient, and long-run transmitted mean -> true gradient."""
    rk = RandomK(fraction=0.25)
    g = {"a": torch.ones((4096,))}
    st = rk.init(g, seed=0)
    acc = torch.zeros((4096,))
    for i in range(40):
        q, st = rk.compress(g, st)
        acc = acc + q["a"]
        total = acc + st["residual"]["a"]
        np.testing.assert_allclose(total, (i + 1) * g["a"], atol=1e-4)
    assert abs(float(acc.mean()) / 40 - 1.0) < 0.15


def test_randomk_converges_quadratic():
    rk = RandomK(fraction=0.3)
    w = torch.tensor([2.0, -3.0, 1.5, 0.7])
    target = torch.tensor([0.5, 0.25, -1.0, 0.0])
    st = rk.init({"w": w}, seed=1)
    for _ in range(400):
        q, st = rk.compress({"w": 2 * (w - target)}, st)
        w = w - 0.05 * q["w"]
    np.testing.assert_allclose(w, target, atol=5e-2)


# ---------------------------- optimizer -------------------------------- #

def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"w": torch.tensor([4.0, -4.0])}
    state = adamw.init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(params, grads, state, cfg)
    assert float(torch.abs(params["w"]).max()) < 0.05


def test_adamw_grad_clip():
    cfg = adamw.AdamWConfig(lr=0.1, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    _, _, gnorm = adamw.update(params, {"w": torch.full((3,), 100.0)}, state,
                               cfg)
    assert float(gnorm) > 100           # reported pre-clip norm
