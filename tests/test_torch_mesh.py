"""The port's sharding surface and its steps on a mesh, against the JAX
package: every spec tree of the ten ids leaf for leaf (params in the
train and decode layouts, ZeRO-1 and AdamW state on one pod and two,
inputs and caches of every applicable cell), the abstract shapes and
dtypes, the mirrors of the reference's launch tests, and a (2, 2) mesh of
four gloo ranks whose train and decode steps equal the un-meshed ones.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models.common import Axes as JAxes
from repro.optim import adamw as jadamw
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.models.common import (SHAPES, Axes, P, cell_applicable,
                                       leaves, local_shape, placements)
from repro_torch.models.layers import shard
from repro_torch.optim import adamw

ROOT = pathlib.Path(__file__).resolve().parent.parent
AXES = [Axes(), Axes(pod="pod")]
AXES_IDS = ["single", "multi_pod"]


def _jax_paths(tree):
    """{path: leaf} of a reference tree (PartitionSpec or
    ShapeDtypeStruct leaves), paths as tuples of dict keys."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _same_specs(mine, ref):
    mine, ref = _paths(mine), _jax_paths(ref)
    assert set(mine) == set(ref)
    for path, spec in mine.items():
        assert tuple(spec) == tuple(ref[path]), path
        assert repr(spec) == repr(ref[path]), path


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _same_abstract(mine, ref, skip=()):
    mine, ref = _paths(mine), _jax_paths(ref)
    assert set(mine) - set(skip) == set(ref)
    for path, leaf in ref.items():
        assert mine[path].device.type == "meta", path
        assert tuple(mine[path].shape) == tuple(leaf.shape), path
        assert _dtype_name(mine[path].dtype) == str(leaf.dtype), path


def _jaxes(axes: Axes) -> JAxes:
    return JAxes(pod=axes.pod)


# --------------------------------------------------------------------- #
# The spec type and placements
# --------------------------------------------------------------------- #

def test_partition_spec_prints_and_compares_as_the_references():
    for entries in [(), (None,), ("data", "model"), (None, "model"),
                    (("pod", "data"), None, "model")]:
        assert repr(P(*entries)) == repr(JP(*entries))
        assert tuple(P(*entries)) == tuple(JP(*entries))
        assert P(*entries) == entries
    assert P(None) != P()


class _Mesh:
    """The two attributes ``placements`` reads of a DeviceMesh."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = names
        self.shape = sizes

    def size(self, i):
        return self.shape[i]


def test_placements_follow_the_mesh_order():
    mesh = _Mesh(("pod", "data", "model"), (2, 16, 16))
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="does not have"):
        placements(P("expert"), mesh)


def test_local_shape_pads_each_split_dim_as_xla():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert local_shape((28, 3584), P("model", "data"), sizes) == (2, 224)
    assert local_shape((128, 100), P(("pod", "data"), None), sizes) == \
        (4, 100)
    assert local_shape((4, 7), P(), sizes) == (4, 7)


def test_shard_is_a_no_op_off_a_mesh():
    x = torch.ones(4, 4)
    assert shard(x, P("data", None)) is x
    assert shard(x, None) is x


# --------------------------------------------------------------------- #
# Spec parity with the JAX package, leaf for leaf
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_equal_the_references(arch, axes):
    api, japi = registry.get(arch), jregistry.get(arch)
    for layout in ("train", "decode"):
        _same_specs(api.param_specs(axes, layout),
                    japi.param_specs(_jaxes(axes), layout))
    _same_specs(api.zero1_specs(axes), japi.zero1_specs(_jaxes(axes)))


@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_state_specs_equal_the_references(arch, axes):
    api, japi = registry.get(arch), jregistry.get(arch)
    mine = adamw.state_specs(api.zero1_specs(axes), axes)
    ref = jadamw.state_specs(japi.zero1_specs(_jaxes(axes)), _jaxes(axes))
    _same_specs(mine, ref)
    if axes.pod:        # ZeRO-1 over pods: some moment carries "pod"
        assert any("pod" in str(s) for s in leaves(mine["m"]))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_abstract_params_and_state_equal_the_references(arch):
    api, japi = registry.get(arch), jregistry.get(arch)
    params = api.abstract_params()
    _same_abstract(params, japi.abstract_params())
    _same_abstract(adamw.abstract_state(params),
                   jadamw.abstract_state(japi.abstract_params()))


@pytest.mark.parametrize("axes", AXES, ids=AXES_IDS)
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_and_cache_specs_equal_the_references(arch, axes):
    """Every applicable cell.  Whisper's cache is the port's own in two
    ways (``models/encdec.py``): a ``cross_len`` leaf, which follows the
    batch, and cross rows rounded up to the decode kernel's; its specs and
    every other leaf are the reference's."""
    api, japi = registry.get(arch), jregistry.get(arch)
    for cell, ok, why in api.applicable_cells():
        if not ok:
            continue
        inputs, specs = api.input_specs(cell, axes)
        jinputs, jspecs = japi.input_specs(cell, _jaxes(axes))
        extra = ()
        if "cache" in specs and "cross_len" in specs["cache"]:
            extra = (("cache", "cross_len"),)
            assert specs["cache"].pop("cross_len") == \
                P(axes.batch if cell.global_batch > 1 else None)
            mine_len = inputs["cache"]["cross_len"]
            assert tuple(mine_len.shape) == (cell.global_batch,)
        _same_specs(specs, jspecs)
        mine, ref = _paths(inputs), _jax_paths(jinputs)
        assert set(mine) - set(extra) == set(ref)
        for path, leaf in ref.items():
            assert mine[path].device.type == "meta"
            assert _dtype_name(mine[path].dtype) == str(leaf.dtype), path
            if path[-1] in ("cross_k", "cross_v"):
                assert mine[path].shape[2] >= leaf.shape[2]
                assert tuple(mine[path].shape[:2]) == leaf.shape[:2]
            else:
                assert tuple(mine[path].shape) == tuple(leaf.shape), path


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mamba2-2.7b"])
def test_mla_and_ssm_cache_specs_equal_the_references(arch):
    from repro.models import mla as jmla
    from repro.models import ssm as jssm
    from repro_torch.models import mla, ssm
    cfg = registry.get(arch).cfg
    for axes in AXES:
        if cfg.mla:
            for seq in (False, True):
                _same_specs(mla.mla_cache_specs(cfg, axes, seq),
                            jmla.mla_cache_specs(cfg, _jaxes(axes), seq))
            cache = mla.mla_init_cache(cfg, 2, 8, device="cpu")
            ref = jmla.mla_init_cache(cfg, 2, 8)
            for k in ref:
                assert tuple(cache[k].shape) == ref[k].shape
        else:
            _same_specs(ssm.ssm_cache_specs(cfg, axes),
                        jssm.ssm_cache_specs(cfg, _jaxes(axes)))


# --------------------------------------------------------------------- #
# Mirrors of the reference's launch tests
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_cover_every_cell(arch, shape):
    """``tests/test_launch.py:16``: every applicable (arch x shape) gives
    abstract inputs and specs of one structure, touching no device."""
    api = registry.get(arch)
    cell = SHAPES[shape]
    ok, why = cell_applicable(api.cfg, cell)
    if not ok:
        assert "SKIP" in why
        return
    inputs, spec_tree = api.input_specs(cell, axes=None)
    assert _paths(inputs).keys() == _paths(spec_tree).keys()
    for leaf in leaves(inputs):
        assert leaf.device.type == "meta"
    if cell.kind == "train":
        assert inputs["tokens"].shape[0] == cell.global_batch
    if cell.kind == "decode":
        assert tuple(inputs["tokens"].shape) == (cell.global_batch, 1)
        assert "cache" in inputs


def test_abstract_train_args_no_allocation():
    """``tests/test_launch.py:61``: DeepSeek-V2's 236B parameters as
    ``meta`` tensors, over 200e9 bytes, nothing allocated."""
    api = registry.get("deepseek-v2-236b")
    params, opt, inputs = steps.abstract_train_args(api, SHAPES["train_4k"])
    for leaf in leaves(params) + leaves(opt) + leaves(inputs):
        assert leaf.device.type == "meta"
    total = sum(t.numel() * t.element_size() for t in leaves(params))
    assert total > 200e9


def test_decode_param_layout_swap():
    """``tests/test_launch.py:71``: spfsdp's decode layout moves "model"
    to the contraction dim; TP archs keep the train layout."""
    axes = Axes()
    api = registry.get("qwen2-7b")
    tl = leaves(api.param_specs(axes))
    dl = leaves(api.param_specs(axes, layout="decode"))
    assert any(t != d for t, d in zip(tl, dl))
    api2 = registry.get("dbrx-132b")
    assert leaves(api2.param_specs(axes)) == \
        leaves(api2.param_specs(axes, layout="decode"))


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group over an in-process store, destroyed after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_smoke_mesh_and_axes(one_rank_group):
    """``tests/test_launch.py:87``; and the production mesh refuses a
    group without its 256 (512) ranks."""
    mesh = mesh_mod.make_smoke_mesh()
    assert set(mesh.mesh_dim_names) == {"data", "model"}
    assert tuple(mesh.shape) == (1, 1)
    ax = Axes.for_mesh(mesh)
    assert ax.pod is None and ax.batch == "data"
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"{need} ranks"):
            mesh_mod.make_production_mesh(multi_pod=multi_pod)


@pytest.mark.parametrize("env, device, want", [
    ({}, "cuda", 0),
    ({}, "cuda:2", 2),
    ({"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}, "cuda", 1),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "3"}, "cuda:0", 3),
], ids=["alone", "alone_indexed", "torchrun", "torchrun_over_index"])
def test_each_launched_process_binds_its_local_rank_card(
        monkeypatch, env, device, want):
    """Under ``torchrun`` every process of a host takes the card of its
    ``LOCAL_RANK``, not the first one; alone, the device's index."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert mesh_mod.card_index(device) == want


def test_a_one_by_one_mesh_runs_the_unmeshed_step(one_rank_group):
    """On a (1, 1) mesh (one card's) the dist steps are the un-meshed
    steps to the bit: every placement holds the whole tensor."""
    api = registry.get_reduced("tinyllama-1.1b")
    mesh = mesh_mod.make_smoke_mesh()
    axes = Axes.for_mesh(mesh)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 256, (2, 12)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    ref_p = api.init_params(0, device="cpu")
    ref = steps.make_train_step(api, None, 2)(ref_p, adamw.init(ref_p),
                                              batch)
    p = api.init_params(0, device="cpu")
    with mesh_mod.enter_mesh(mesh):
        got = steps.dist_train_step(api, axes, 2)(p, adamw.init(p), batch)
        logits, cache = steps.dist_prefill_step(api, axes, 16)(
            got[2], {"tokens": toks[:, :8]})
        step_logits, _ = steps.dist_decode_step(api, axes)(
            got[2], cache, toks[:, 8:9], 8)
    assert float(got[0].full_tensor()) == float(ref[0])
    for a, b in zip(leaves(ref[2]), leaves(got[2])):
        assert torch.equal(a, b.full_tensor())
    ref_logits, ref_cache = api.prefill_fn(ref[2], {"tokens": toks[:, :8]},
                                           max_len=16)
    assert torch.equal(logits.full_tensor(), ref_logits)
    assert torch.equal(step_logits.full_tensor(),
                       api.decode_fn(ref[2], ref_cache, toks[:, 8:9], 8)[0])


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cell_applicability_matrix(arch):
    """``tests/test_models_smoke.py::test_cell_applicability_matrix``:
    long_500k only for the sub-quadratic archs."""
    api = registry.get(arch)
    cells = {c.name: ok for c, ok, _ in api.applicable_cells()}
    assert cells["train_4k"] and cells["prefill_32k"] and cells["decode_32k"]
    assert cells["long_500k"] == (arch in ("mamba2-2.7b", "zamba2-2.7b"))
    jcells = {c.name: ok for c, ok, _ in
              jregistry.get(arch).applicable_cells()}
    assert cells == jcells


def test_abstract_serve_args_are_the_references():
    api, japi = registry.get("tinyllama-1.1b"), \
        jregistry.get("tinyllama-1.1b")
    for name in ("prefill_32k", "decode_32k"):
        mine = steps.abstract_serve_args(api, SHAPES[name])
        ref = jsteps.abstract_serve_args(japi, SHAPES[name])
        assert len(mine) == len(ref)
        for m, r in zip(mine, ref):
            _same_abstract(m, r)


# --------------------------------------------------------------------- #
# PyTorch 2.11's view rule
# --------------------------------------------------------------------- #

@pytest.fixture
def fake_two_by_two():
    """A (2, 2) ("data", "model") mesh over a fake group of four ranks
    (collectives return at once), destroyed after."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _on(mesh, shape, pl):
    """A DTensor of ``shape`` laid out by ``pl`` (rank 0's shard)."""
    gen = torch.Generator().manual_seed(0)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.randn(local, generator=gen), mesh, pl,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape).stride())


def test_the_view_rule_refuses_what_torch_2_11_refuses(fake_two_by_two):
    """``StrictViews`` raises where the card machine's PyTorch 2.11
    refused the mesh path before: a product of attention blocks with the
    batch and the heads split (``flash_attention``), an activation with
    the batch and the sequence split times a weight (spfsdp's
    projections), and a pad of a DTensor (the prefill's cache rows).  The
    port's ``flash_attention``, ``linear`` and ``pad_end`` pass it on the
    same tensors, and a product that splits only the first of the dims it
    merges passes too."""
    import torch.nn.functional as F

    from repro_torch.launch.view_rule import StrictViews
    from repro_torch.models import layers
    mesh = fake_two_by_two
    heads = (Shard(0), Shard(2))                 # (B, S, H, D): tp
    q, k, v = (_on(mesh, (4, 8, 4, 16), heads) for _ in range(3))
    rows = _on(mesh, (4, 8, 64), (Shard(0), Shard(1)))   # spfsdp
    w = _on(mesh, (64, 32), (Replicate(), Replicate()))
    with StrictViews():
        with pytest.raises(RuntimeError, match="flatten multiple"):
            q.transpose(1, 2) @ k.transpose(1, 2).transpose(-1, -2)
        with pytest.raises(RuntimeError, match="flatten multiple"):
            rows @ w
        with pytest.raises(RuntimeError, match="constant_pad_nd"):
            F.pad(q, (0, 0, 0, 0, 0, 8))
        out = layers.flash_attention(q, k, v)
        assert tuple(out.placements) == heads and out.shape == q.shape
        y = layers.linear(rows, w)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert y.shape == (4, 8, 32)
        padded = layers.pad_end(q, 1, 16)
        assert tuple(padded.placements) == heads
        assert padded.shape == (4, 16, 4, 16)
        batch_only = _on(mesh, (4, 8, 64), (Shard(0), Replicate()))
        assert (batch_only @ w).shape == (4, 8, 32)
    # the local shards are the plain functions' on rank 0's shard
    torch.testing.assert_close(
        y.to_local(), rows.to_local() @ w.to_local())
    torch.testing.assert_close(
        padded.to_local(), F.pad(q.to_local(), (0, 0, 0, 0, 0, 8)))
    torch.testing.assert_close(
        out.to_local(), layers.flash_attention(
            q.to_local(), k.to_local(), v.to_local()))


# --------------------------------------------------------------------- #
# Four gloo ranks on a (2, 2) mesh
# --------------------------------------------------------------------- #

# float32 weights and caches: what differs is the order of float32 sums
# (a contraction split over "data" or "model" is summed shard by shard)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4       # after one AdamW step of lr 5e-3 (|update| ~ lr)
GRAD_ATOL = 1e-6        # the clipped gradients, of magnitude up to ~0.1
# two decode steps' float32 caches, relative to the prefill cache's
# largest entry: 1e-5 at the KV caches' ~3.5, 4.8e-5 at Mamba2's state
# (17.2: a carried sum)
CACHE_RTOL = 2.8e-6
LOGIT_ATOL = 5e-5       # logits of magnitude ~3


def test_four_ranks_on_a_two_by_two_mesh_equal_the_unmeshed_steps(
        tmp_path):
    """Reduced TinyLlama (tp), Qwen2-7B (spfsdp, its decode layout), DBRX
    (MoE, block-local routing with expert parallelism), Mamba2 (the SSD
    layer split by heads) and Whisper (the encoder-decoder, from seeded
    stub frames): one train step, and a prefill and two decode steps at
    batch 4 and at batch 1, through ``dist_*_step`` on four spawned gloo
    ranks (a ``FileStore``: no port, no network) equal the un-meshed
    steps, every meshed step under PyTorch 2.11's view rule
    (``StrictViews``).  Every decoder-only attention cache has its
    sequence split (over "model" at batch 4, over "data" at batch 1), so
    each device's decode kernel walks its own rows and the combine takes
    the gathered partials; Whisper's caches split the batch (not a batch
    of one, which a split would read back from ``local_map`` twice as
    long, refused as a merged split dim under 2.11's rule) and the
    heads.  The prefill's bfloat16 cache may round an entry to its
    neighbour (one bfloat16 step of its magnitude)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    store = tmp_path / "store"
    results = _run_ranks(
        [[str(rank), "4", str(store), str(tmp_path)] for rank in range(4)],
        [env] * 4, tmp_path)
    _same_as_unmeshed(results, "cpu")


def _run_ranks(args, envs, out_dir):
    """The four workers, spawned with ``args`` and ``envs``; their JSON."""
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"), *a],
        env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a, e in zip(args, envs)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(4)]


# the placements of the stacked caches, (L, B, ...) on ("data", "model"),
# at batch 4 and at batch 1: an attention cache's sequence (dim 2) is
# split over "model" at batch 4 and over "data" at batch 1; Mamba2's
# state (L, B, H, P, N) and conv tail (L, B, W-1, C) by the batch and
# the heads (channels); Whisper's (L, B, S, H, D) caches by the batch (at
# batch 4) and the heads, its cross_len (B,) by the batch
CACHE_PLACEMENTS = {
    "attention": (["(Shard(dim=1), Shard(dim=2))"],
                  ["(Shard(dim=2), Replicate())"]),
    "mamba2-2.7b": (["(Shard(dim=1), Shard(dim=2))",
                     "(Shard(dim=1), Shard(dim=3))"],
                    ["(Replicate(), Shard(dim=2))",
                     "(Replicate(), Shard(dim=3))"]),
    "whisper-medium": (["(Shard(dim=0), Replicate())",
                        "(Shard(dim=1), Shard(dim=3))"],
                       ["(Replicate(), Replicate())",
                        "(Replicate(), Shard(dim=3))"]),
}
MESH_ARCHS = ("tinyllama-1.1b", "qwen2-7b", "dbrx-132b", "mamba2-2.7b",
              "whisper-medium")


def _same_as_unmeshed(results, device: str):
    for res in results:
        assert res["mesh"] == [2, 2]
        for arch in MESH_ARCHS:
            r = res[arch]
            ref_loss, loss = r["loss"]
            assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), arch
            ref_norm, norm = r["gnorm"]
            assert abs(norm - ref_norm) <= LOSS_RTOL * ref_norm, arch
            assert r["params"] <= PARAM_ATOL, arch
            assert r["grads"] <= GRAD_ATOL, arch
            # two steps of every attention layer: on the card each
            # launches the decode kernel over its shard's rows and the
            # combine; Whisper's self and cross attentions each launch
            # the kernel over a shard of whole caches, in one range (its
            # 16 rows take one split), so no combine
            cfg = registry.get_reduced(arch).cfg
            steps_k5 = 2 * cfg.n_layers \
                if device == "cuda" and cfg.n_heads else 0
            k5 = {"flash_decode": steps_k5, "flash_decode_combine": steps_k5}
            if cfg.family == "audio":
                k5 = {"flash_decode": 4 * (cfg.dec_layers or cfg.n_layers)
                      if device == "cuda" else 0,
                      "flash_decode_combine": 0}
            b4, b1 = CACHE_PLACEMENTS.get(arch,
                                          CACHE_PLACEMENTS["attention"])
            for case, want in ((r, b4), (r["batch1"], b1)):
                assert case["prefill_cache_placements"] == want, arch
                assert case["cache_placements"] == want, arch
                assert case["prefill_logits"] <= LOGIT_ATOL, arch
                diff, scale = case["cache"]
                assert diff <= scale * 2 ** -7, arch
                assert max(case["decode_logits"]) <= LOGIT_ATOL, arch
                assert case["decode_cache"] <= CACHE_RTOL * scale, arch
                assert case["decode_launches"] == k5, arch
    # every rank saw the same numbers
    assert all(res == results[0] for res in results)


@pytest.mark.gpu
def test_four_cards_on_a_two_by_two_mesh_equal_the_unmeshed_steps(
        tmp_path):
    """The four-rank check on four cards of one host: NCCL, one card a
    rank (``LOCAL_RANK``), ``torchrun``'s environment with a free port on
    ``localhost``: the train step, the prefill and the decode steps at
    batch 4 and 1, the decode kernel and the combine on every card's
    shard of the sequence-split caches.  Tolerances as on the CPU."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the decode kernel has no "
                    "CPU mode, and each rank takes a card")
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                MASTER_PORT=str(port), WORLD_SIZE="4")
    base.pop("JAX_PLATFORMS", None)
    envs = [dict(base, RANK=str(r), LOCAL_RANK=str(r)) for r in range(4)]
    results = _run_ranks([["cuda", str(tmp_path)]] * 4, envs, tmp_path)
    assert [res["device"] for res in results] == \
        [f"cuda:{r}" for r in range(4)]
    _same_as_unmeshed([{k: v for k, v in res.items() if k != "device"}
                       for res in results], "cuda")


# --------------------------------------------------------------------- #
# The launchers on a mesh
# --------------------------------------------------------------------- #

def test_the_train_loop_on_a_mesh_equals_the_unmeshed_loop(
        one_rank_group, tmp_path):
    """``--full``'s loop (``train._train_loop`` with axes, every step
    through ``dist_train_step``) on the one-rank mesh, with a checkpoint
    and a restart: the losses of the un-meshed loop, to the bit."""
    from repro_torch.launch import train as train_mod
    api = registry.get_reduced("tinyllama-1.1b")
    kw = dict(steps=3, batch=2, seq_len=16, checkpoint_every=2, lr=3e-4,
              log_every=100, num_microbatches=2)
    ref = train_mod._train_loop(api, torch.device("cpu"), ckpt_dir=None,
                                **kw)
    mesh = mesh_mod.make_smoke_mesh()
    with mesh_mod.enter_mesh(mesh):
        d = str(tmp_path / "ckpt")
        first = train_mod._train_loop(
            api, torch.device("cpu"), ckpt_dir=d, axes=Axes(),
            **dict(kw, steps=2))
        resumed = train_mod._train_loop(api, torch.device("cpu"),
                                        ckpt_dir=d, axes=Axes(), **kw)
    assert first.losses + resumed.losses == ref.losses
    assert resumed.start_step == 2
    for a, b in zip(leaves(ref.params), leaves(resumed.params)):
        assert torch.equal(a, b.full_tensor())


def test_full_training_on_one_device_runs_the_local_program(
        one_rank_group, monkeypatch):
    """``train(smoke=False)`` on a group of one rank lays out the (1, 1)
    mesh and runs its local program, the un-meshed step on plain
    tensors, never ``dist_train_step`` (DTensor's dispatch would shard
    nothing there); the reduced config stands in for the published one."""
    from repro_torch.launch import train as train_mod

    def no_dist(*args, **kwargs):
        raise AssertionError("dist_train_step on a one-device mesh")

    kw = dict(steps=2, batch=2, seq_len=16, lr=3e-4, log_every=100,
              num_microbatches=2, device="cpu")
    ref = train_mod.train("tinyllama-1.1b", **kw)
    reduced = registry.get_reduced("tinyllama-1.1b")
    monkeypatch.setattr(train_mod.registry, "get", lambda arch: reduced)
    monkeypatch.setattr(train_mod.steps_mod, "dist_train_step", no_dist)
    run = train_mod.train("tinyllama-1.1b", smoke=False, **kw)
    assert run.losses == ref.losses
    assert not any(isinstance(t, DTensor) for t in leaves(run.params))
    for a, b in zip(leaves(ref.params), leaves(run.params)):
        assert torch.equal(a, b)


def test_serving_on_a_mesh_generates_the_unmeshed_tokens(one_rank_group):
    """The serve loop through ``dist_prefill_step`` and
    ``dist_decode_step`` (eager, on the CPU) on the one-rank mesh."""
    from repro_torch.launch import serve as serve_mod
    for arch in ("tinyllama-1.1b", "mamba2-2.7b"):
        api = registry.get_reduced(arch)
        params = api.init_params(0, device="cpu")
        ref = serve_mod._serve_loop(api, params, batch=2, prompt_len=8,
                                    gen_len=4)
        mesh = mesh_mod.make_smoke_mesh()
        with mesh_mod.enter_mesh(mesh):
            run = serve_mod._serve_loop(api, params, batch=2, prompt_len=8,
                                        gen_len=4, axes=Axes())
        assert np.array_equal(run.tokens, ref.tokens), arch


def test_full_multi_pod_without_its_ranks_is_an_error():
    """``--full --multi-pod`` on a group without 512 ranks raises before
    any weight is made."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    try:
        for run in (train_mod.train, serve_mod.serve):
            with pytest.raises(ValueError, match="512 ranks"):
                run("tinyllama-1.1b", smoke=False, multi_pod=True,
                    device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
