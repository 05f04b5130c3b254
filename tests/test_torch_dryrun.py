"""The port's dry run and its statistics.

``launch.hlo_stats`` counts a step from the ATen operations each device
runs (the JAX package's ``tests/test_hlo_stats.py``, mirrored: a
loop-free product exactly, a repeated body multiplied by its trips, a
gradient's forward and backward, and the collectives of a known
redistribute by kind).  ``launch.dryrun`` runs in a process of its own
(it makes a fake process group of 256 or 512 ranks), on the reference's
integration cells: its JSON has the reference's contract, its argument
bytes are what the JAX package's own specs give on that mesh, its
products cover the cell's model FLOPs, and a full-attention arch at
long_500k is the reference's skip record.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.models import registry as jregistry
from repro.models.common import SHAPES as JSHAPES
from repro.models.common import Axes as JAxes
from repro.optim import adamw as jadamw
from repro_torch.launch import hlo_stats
from repro_torch.launch.model_flops import model_flops
from repro_torch.models import registry
from repro_torch.models import trips
from repro_torch.models.common import SHAPES

ROOT = pathlib.Path(__file__).resolve().parent.parent


# --------------------------------------------------------------------- #
# hlo_stats
# --------------------------------------------------------------------- #

def test_a_loop_free_product_is_counted_exactly():
    a, b = torch.randn(256, 512), torch.randn(512, 128)
    _, st, ran = hlo_stats.count(lambda a, b: torch.tanh(a @ b), a, b)
    assert st.flops == 2 * 256 * 512 * 128
    # mm reads a and b and writes its product; tanh reads and writes it
    assert st.bytes_accessed == 4 * (256 * 512 + 512 * 128
                                     + 3 * 256 * 128)
    assert st.collective_total == 0 and st.unknown_trip_loops == 0
    assert ran.flops == st.flops


def test_a_repeated_body_runs_once_and_counts_its_trips():
    n_layers, d = 7, 64
    runs = []

    def f(x, ws):
        for i in trips.loop(range(n_layers)):
            runs.append(i)
            x = torch.tanh(x @ ws[i])
        return x.sum()

    x, ws = torch.randn(32, d), torch.randn(n_layers, d, d)
    _, st, ran = hlo_stats.count(f, x, ws)
    assert runs == [0]
    assert st.flops == n_layers * 2 * 32 * d * d
    assert ran.flops == 2 * 32 * d * d
    assert st.unknown_trip_loops == 0
    # outside a count the loop is the plain loop
    runs.clear()
    f(x, ws)
    assert runs == list(range(n_layers))


def test_a_gradient_counts_forward_and_backward():
    n_layers, d, b = 6, 48, 8
    x = torch.randn(b, d, requires_grad=True)
    ws = [torch.randn(d, d, requires_grad=True) for _ in range(n_layers)]

    def f(x, *ws):
        y = x
        for w in ws:
            y = torch.tanh(y @ w)
        return torch.autograd.grad(y.sum(), (x, *ws))

    _, st, _ = hlo_stats.count(f, x, *ws)
    fwd = n_layers * 2 * b * d * d
    # forward, and the two products of each layer's backward
    assert st.flops == 3 * fwd


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_counts_the_blocks_it_skips(monkeypatch, causal):
    """Under a count ``layers.flash_attention`` runs one query chunk, its
    first KV block and one rescaling block; multiplied out, its FLOPs and
    bytes equal those of every block run (the loops made plain), FLOPs in
    the backward pass too, whose operations run after the loops have
    ended."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 96, 4, 16, generator=gen) for _ in range(3))

    def attend(q, k, v):
        return layers.flash_attention(q, k, v, causal=causal, q_chunk=32,
                                      kv_chunk=24)

    def attend_and_grad(q, k, v):
        return torch.autograd.grad(attend(q, k, v).square().sum(),
                                   (q, k, v))

    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counted = [hlo_stats.count(f, q, k, v)
               for f in (attend, attend_and_grad)]
    monkeypatch.setattr(trips, "loop", lambda items: iter(list(items)))
    for (_, st, ran), f in zip(counted, (attend, attend_and_grad)):
        _, whole, _ = hlo_stats.count(f, q, k, v)
        assert ran.flops < whole.flops
        assert st.flops == whole.flops
        assert st.unknown_trip_loops == 0
        if f is attend:
            assert st.bytes_accessed == whole.bytes_accessed
        else:
            # the gradient sums into what every trip reads (a query
            # chunk, each KV chunk, the running max) count the trips
            # that ran only: a lower bound
            assert ran.bytes_accessed < st.bytes_accessed \
                <= whole.bytes_accessed


@pytest.fixture
def fake_mesh():
    """A (2, 2) mesh over a fake group of four ranks, destroyed after."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("src,dst,kind,result_elems", [
    ((Shard(0), Replicate()), (Replicate(), Replicate()), "all-gather",
     8 * 16),
    ((Partial(), Replicate()), (Replicate(), Replicate()), "all-reduce",
     8 * 16),
    ((Partial(), Replicate()), (Shard(0), Replicate()), "reduce-scatter",
     4 * 16),
    ((Shard(0), Replicate()), (Shard(1), Replicate()), "all-to-all",
     8 * 8),
])
def test_collectives_of_a_redistribute_are_counted_by_kind(
        fake_mesh, src, dst, kind, result_elems):
    """One collective over the "data" dim of an (8, 16) float32 tensor:
    its result's bytes on one device, under its own kind (the CPU mesh
    runs the all-to-all as an all-gather and a slice; it counts as the
    all-to-all DTensor asked for)."""
    local = torch.zeros((4 if src[0] == Shard(0) else 8, 16))
    x = DTensor.from_local(local, fake_mesh, src, run_check=False,
                           shape=(8, 16), stride=(16, 1))
    _, st, _ = hlo_stats.count(lambda t: t.redistribute(fake_mesh, dst), x)
    assert st.collective_bytes[kind] == result_elems * 4
    assert st.collective_count == 1
    assert st.collective_total == result_elems * 4


@pytest.fixture
def fake_production_mesh():
    """The (16, 16) ("data", "model") mesh over a fake group of 256 ranks,
    destroyed after."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield init_device_mesh("cpu", (16, 16),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_the_ssd_projection_gathers_nothing_on_the_production_mesh(
        fake_production_mesh, monkeypatch):
    """Mamba2 reduced to 16 SSD heads (d_model 128) on the 16 x 16 mesh:
    the loss and its gradients, the prefill and a decode step, counted
    by ``hlo_stats.count``, issue no collective inside ``_split_proj``
    (the JAX package keeps the projection split by heads), and each
    device's projection products are its own 1/16 of the columns."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import ssm
    from repro_torch.models.common import Axes
    api = registry.get_reduced("mamba2-2.7b", d_model=128)
    cfg = api.cfg
    assert cfg.ssm_heads == 16
    moved, flops = [], []
    split = ssm._split_proj

    def attributed(*a):
        st = hlo_stats._RAN[-1]
        c0, f0 = st.collective_total, st.flops
        out = split(*a)
        moved.append(st.collective_total - c0)
        flops.append(st.flops - f0)
        return out

    monkeypatch.setattr(ssm, "_split_proj", attributed)
    axes = Axes()
    b, s = 32, 16
    toks = torch.randint(3, cfg.vocab, (b, s),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks}
    proj_cols = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    with mesh_mod.enter_mesh(fake_production_mesh):
        params = steps.distribute(api.init_params(0, device="cpu"),
                                  api.param_specs(axes))
        data = steps.distribute(batch, steps.batch_specs(batch, axes))
        hlo_stats.count(steps.value_and_grad, api, params, data, axes)
        # forward, and again in the backward (each layer recomputed)
        assert len(moved) == 2 * cfg.n_layers
        # one device: b / 16 rows of s tokens, 1/16 of the columns
        assert flops == [2 * (b // 16) * s * cfg.d_model * proj_cols
                         / 16] * len(flops)
        moved.clear()
        (_, cache), _, _ = hlo_stats.count(
            steps.dist_prefill_step(api, axes, s), params,
            {"tokens": toks})
        hlo_stats.count(steps.dist_decode_step(api, axes), params, cache,
                        toks[:, :1], s)
        assert len(moved) == 2 * cfg.n_layers
    assert moved == [0.0] * len(moved)


# --------------------------------------------------------------------- #
# The dry run, in processes of its own
# --------------------------------------------------------------------- #

# the reference's two integration cells, then a train cell of each
# sharding policy ("tp", "spfsdp") and an MoE decode cell
CELLS = [("tinyllama-1.1b", "decode_32k", False),
         ("mamba2-2.7b", "long_500k", True),
         ("tinyllama-1.1b", "train_4k", False),
         ("qwen2-7b", "train_4k", False),
         ("dbrx-132b", "decode_32k", False)]


def _run(out_dir, arch, shape, multi_pod):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", str(out_dir)]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    """The integration cells and the skip cell, run side by side once."""
    out = tmp_path_factory.mktemp("dryrun")
    cells = CELLS + [("tinyllama-1.1b", "long_500k", False)]
    procs = [_run(out, *c) for c in cells]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = {}
    for arch, shape, multi_pod in cells:
        tag = "pod" if multi_pod else "single"
        results[arch, shape] = json.loads(
            (out / f"{arch}_{shape}_{tag}.json").read_text())
    return results


def _reference_argument_bytes(arch, shape, multi_pod) -> int:
    """One device's argument bytes of the JAX package's step for the cell
    on the production mesh, from its own specs (``jit_train_step``'s or
    ``jit_decode_step``'s in_shardings): every leaf's shape with each
    split dim divided by its axes' sizes, rounded up."""
    japi = jregistry.get(arch)
    axes = JAxes(pod="pod" if multi_pod else None)
    sizes = {"pod": 2, "data": 16, "model": 16}
    cell = JSHAPES[shape]
    inputs, ispecs = japi.input_specs(cell, axes)
    params = japi.abstract_params(axes)
    if cell.kind == "train":
        pairs = [(params, japi.param_specs(axes)),
                 (jadamw.abstract_state(params),
                  jadamw.state_specs(japi.zero1_specs(axes), axes)),
                 (inputs, ispecs)]
    else:
        pairs = [(params, japi.param_specs(axes, layout="decode")),
                 (inputs["cache"], ispecs["cache"]),
                 (inputs["tokens"], ispecs["tokens"]),
                 (inputs["pos"], ispecs["pos"])]
    total = 0
    for tree, specs in pairs:
        is_spec = lambda s: isinstance(s, JP)                # noqa: E731
        for leaf, spec in zip(jax.tree.leaves(tree),
                              jax.tree.leaves(specs, is_leaf=is_spec),
                              strict=True):
            dims = list(leaf.shape)
            for d, entry in enumerate(spec):
                names = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                n = math.prod(sizes[a] for a in names)
                dims[d] = -(-dims[d] // n)
            total += math.prod(dims) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_dryrun_cell_subprocess(dry_runs, arch, shape, multi_pod):
    cell = dry_runs[arch, shape]
    assert cell["status"] == "ok"
    assert cell["kind"] == SHAPES[shape].kind
    assert cell["chips"] == (512 if multi_pod else 256)
    assert cell["mesh"] == ("pod2x16x16" if multi_pod else "16x16")
    assert cell["compile_s"] == 0.0 and cell["lower_s"] > 0
    a = cell["analyzed"]
    assert a["unknown_trip_loops"] == 0
    assert a["bytes_accessed_per_device"] > 0
    assert set(a["collective_bytes_per_device"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    mem = cell["memory"]
    assert mem["argument_bytes"] == \
        _reference_argument_bytes(arch, shape, multi_pod)
    assert mem["peak_device_bytes"] >= mem["argument_bytes"]
    # no work left out: the devices' products cover the cell's model FLOPs
    mf = model_flops(registry.get(arch), SHAPES[shape])
    assert a["matmul_flops_per_device"] * cell["chips"] >= 0.95 * mf


def test_dryrun_skip_cell(dry_runs):
    """long_500k on a full-attention arch is the reference's SKIP
    record."""
    cell = dry_runs["tinyllama-1.1b", "long_500k"]
    assert cell["status"] == "skipped"
    assert "sub-quadratic" in cell["reason"]


def test_the_dryrun_refuses_a_process_that_has_a_group():
    from repro_torch.launch import dryrun
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process of its own"):
            dryrun.lower_cell("tinyllama-1.1b", "decode_32k", False)
    finally:
        dist.destroy_process_group()
