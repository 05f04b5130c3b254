"""The port's transformer family against the JAX package, on the CPU, at
the reduced configs (2 layers, d_model 64, 4 heads / 2 KV heads; 4
experts top-2 with one shared for DeepSeek; MLA with kv_lora 32, rope 8):
the JAX package's ``init_params`` carried across by
``reference_io.params_from_numpy``, then prefill logits and cache and
teacher-forced decode steps compared, ``moe_ffn`` and MLA's functions one
by one, the configs field by field.

Tolerances: the logits and cache ones of ``test_torch_serve.py``
(``LOGIT_TOL``, ``CACHE_TOL``; their reasons are stated there), for every
id, MLA's included: its absorbed decode is float32 einsums in both
packages, in the same order of products, so it is held to the same
``1e-5`` of the largest logit in float32 and ``3e-2`` in bfloat16 (its
cache is bf16 on both sides, as GQA's).  Decode against the port's own
prefill takes the JAX test's tolerance (``tests/test_models_smoke.py:
78-81``): exact for dense and MoE, ``0.02`` for MLA, whose absorbed
decode takes its products in another order than prefill's decompressed
attention.
"""
import ast
import dataclasses
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models.common import count_params as jcount
from repro_torch.kernels import flash_decode, ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.models import (encdec, hybrid, layers, mamba_lm, mla, moe,
                                registry, ssm, transformer)
from repro_torch.models.common import count_params, leaves
from repro_torch.reference_io import params_from_numpy
from test_torch_serve import CACHE_TOL, LOGIT_TOL

NEW_IDS = ("qwen2-7b", "qwen2.5-14b", "qwen2.5-32b", "chameleon-34b",
           "dbrx-132b", "deepseek-v2-236b")
MOE_IDS = ("dbrx-132b", "deepseek-v2-236b")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(arch, dtype, **over):
    """The reduced arch in both packages, with the JAX package's weights
    (cast to ``dtype``) carried into the port."""
    japi = jregistry.get_reduced(arch, **over)
    api = registry.get_reduced(arch, **over)
    jparams = japi.init_params(jax.random.key(1))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jparams), api.cfg, device="cpu",
        dtype=torch.float32 if dtype == "float32" else None)
    return japi, jparams, api, params


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_IDS)
def test_prefill_and_teacher_forced_decode_match_jax(arch, dtype):
    japi, jparams, api, params = _both(arch, dtype)
    b, t, n_steps = 2, 8, 3
    toks = _tokens(80, b, t + n_steps, api.cfg.vocab)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :t])},
                             max_len=16)
    tl, tc = api.prefill_fn(params, {"tokens": torch.from_numpy(toks[:, :t])},
                            max_len=16)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _rel(tl.numpy(), jl) <= LOGIT_TOL[dtype]
    assert set(tc) == set(jc) == ({"c_kv", "k_pe"} if api.cfg.mla
                                  else {"k", "v"})
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].dtype == torch.bfloat16
        assert _rel(tc[name].float().numpy(), jc[name]) <= CACHE_TOL[dtype]
    for pos in range(t, t + n_steps):
        jl, jc = japi.decode_fn(jparams, jc, jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.int32(pos))
        tl, tc = api.decode_fn(params, tc,
                               torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL[dtype], pos
    for name in tc:
        assert _rel(tc[name].float().numpy(), jc[name]) <= CACHE_TOL[dtype]


@pytest.mark.parametrize("arch", NEW_IDS)
def test_decode_matches_prefill(arch):
    """Decoding token T with the prefill cache == prefilling T+1 tokens,
    the JAX test's case (``tests/test_models_smoke.py:62-81``: b 2, T 8,
    16 rows) on the port's own bf16 weights, at its tolerance."""
    api = registry.get_reduced(arch)
    params = api.init_params(1, device="cpu")
    b, t = 2, 8
    toks = torch.from_numpy(_tokens(81, b, t + 1, api.cfg.vocab))
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :t]}, max_len=16)
    logits_d, _ = api.decode_fn(params, cache, toks[:, t:t + 1], t)
    logits_full, _ = api.prefill_fn(params, {"tokens": toks}, max_len=16)
    tol = 0.02 if api.cfg.mla else 0.0
    assert _rel(logits_d.numpy(), logits_full.numpy()) <= tol + 1e-6


def _jax_top_e(x, router, k):
    probs = jax.nn.softmax(jnp.asarray(x).astype(jnp.float32)
                           @ jnp.asarray(router), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_IDS)
def test_moe_ffn_matches_jax(arch, capacity_factor):
    """``moe_ffn`` of layer 0 on the same x, float32: the routing (top_e)
    equal, the output within ``1e-5`` of its largest entry (f32 on both
    sides, products in another order).  At a capacity factor of 0.5 the
    capacity (8 slots per expert) is below the load (64 pairs over 4
    experts), so tokens are dropped, as the test checks."""
    japi, jparams, api, params = _both(arch, "float32",
                                       capacity_factor=capacity_factor)
    cfg = api.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ffn"])
    p = {name: (v[0] if not isinstance(v, dict)
                else {n: w[0] for n, w in v.items()})
         for name, v in params["layers"]["ffn"].items()}
    x = np.random.default_rng(82).standard_normal((2, 16, cfg.d_model)
                                                  ).astype(np.float32)
    _, top_e = moe.route(torch.from_numpy(x).reshape(32, -1), p["router"],
                         cfg.top_k)
    np.testing.assert_array_equal(
        top_e.numpy(), _jax_top_e(x.reshape(32, -1), jp["router"], cfg.top_k))
    counts = np.bincount(top_e.numpy().ravel(), minlength=cfg.n_experts)
    dropped = moe.dropped_pairs(torch.from_numpy(x), p["router"], cfg)
    assert dropped == np.maximum(counts - moe._capacity(32, cfg), 0).sum()
    assert (dropped > 0) == (capacity_factor < 1), counts
    got = moe.moe_ffn(torch.from_numpy(x), p, cfg)
    want = jmoe.moe_ffn(jnp.asarray(x), jp, japi.cfg, None)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_cache_and_decode_match_jax(dtype):
    """MLA's prefill cache, prefill attention and absorbed decode of layer
    0 against the JAX package's, on the same x: the cache within
    ``CACHE_TOL``, the outputs within ``LOGIT_TOL`` of their largest
    entry; the decode writes row ``pos`` in place."""
    japi, jparams, api, params = _both("deepseek-v2-236b", dtype)
    cfg = api.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    p = {name: w[0] for name, w in params["layers"]["attn"].items()}
    rng = np.random.default_rng(83)
    b, s, max_len = 2, 6, 12
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(p["wq_a"].dtype)
    xj = jnp.asarray(x).astype(jparams["embed"].dtype)
    pos_t = torch.arange(s)[None].expand(b, s)
    pos_j = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    got = mla.mla_prefill_cache(xt, p, cfg, pos_t, max_len)
    want = jmla.mla_prefill_cache(xj, jp, japi.cfg, pos_j, max_len)
    for name in ("c_kv", "k_pe"):
        assert tuple(got[name].shape) == want[name].shape
        assert _rel(got[name].float().numpy(), want[name]) <= CACHE_TOL[dtype]
    assert _rel(mla.mla_attention(xt, p, cfg, pos_t).float().numpy(),
                jmla.mla_attention(xj, jp, japi.cfg, None, pos_j)
                ) <= LOGIT_TOL[dtype]
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    out = mla.mla_decode(torch.from_numpy(x1).to(xt.dtype), p, cfg, got,
                         torch.tensor(s, dtype=torch.int32))
    jout, jcache = jmla.mla_decode(jnp.asarray(x1).astype(xj.dtype), jp,
                                   japi.cfg, None, want, jnp.int32(s))
    assert _rel(out.float().numpy(), jout) <= LOGIT_TOL[dtype]
    for name in ("c_kv", "k_pe"):
        assert bool(got[name][:, s].abs().sum() > 0)
        assert _rel(got[name].float().numpy(), jcache[name]) \
            <= CACHE_TOL[dtype]


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_tensor_pos_decode_equals_int_pos_decode(arch):
    """``pos`` as a 0-d int32 tensor and as a Python int give the same
    logits and cache (every leaf of its tree), bit for bit; Whisper's
    prefill takes 6 frames of stub embeddings instead of 6 tokens."""
    api = registry.get_reduced(arch)
    params = api.init_params(2, device="cpu")
    toks = torch.from_numpy(_tokens(84, 2, 7, api.cfg.vocab))
    batch = {"tokens": toks[:, :6]}
    if api.cfg.family == "audio":
        batch = {"frames": torch.from_numpy(np.random.default_rng(84)
                                            .standard_normal(
            (2, 6, api.cfg.d_model)).astype(np.float32)).to(torch.bfloat16)}
    out = []
    for pos in (6, torch.tensor(6, dtype=torch.int32)):
        _, cache = api.prefill_fn(params, batch, max_len=10)
        logits, cache = api.decode_fn(params, cache, toks[:, 6:], pos)
        out.append((logits, cache))
    (l_int, c_int), (l_t, c_t) = out
    assert torch.equal(l_int, l_t)
    for a, b in zip(leaves(c_int), leaves(c_t), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_configs_and_parameter_counts_are_the_reference_ones(arch):
    api, japi = registry.get(arch), jregistry.get(arch)
    assert dataclasses.asdict(api.cfg) == dataclasses.asdict(japi.cfg)
    assert dataclasses.asdict(registry.get_reduced(arch).cfg) == \
        dataclasses.asdict(jregistry.get_reduced(arch).cfg)
    assert api.count_params() == jcount(japi.param_defs())
    assert count_params(registry.get_reduced(arch).param_defs()) == \
        jcount(jregistry.get_reduced(arch).param_defs())


@pytest.mark.parametrize("arch", NEW_IDS)
def test_serve_runs_end_to_end_on_the_cpu(arch):
    run = serve_mod.serve(arch, batch=2, prompt_len=8, gen_len=3,
                          device="cpu")
    cfg = registry.get_reduced(arch).cfg
    assert run.tokens.shape == (2, 3)
    assert 0 <= run.tokens.min() and run.tokens.max() < cfg.padded_vocab
    assert run.capture_ms is None and run.replays == 0      # eager on CPU


def test_param_defs_build_the_reference_moe_and_mla_trees():
    """``transformer.param_defs`` of an MoE and an MLA config has the JAX
    package's names and shapes, leaf by leaf; the router is float32 and
    every other weight bfloat16, as there."""
    cfg = registry.get_reduced("tinyllama-1.1b").cfg
    for over in (dict(n_experts=4, top_k=2), dict(n_experts=4, top_k=2,
                                                  n_shared_experts=1),
                 dict(mla=True, kv_lora_rank=32, q_lora_rank=48,
                      qk_rope_head_dim=8, qk_nope_head_dim=16,
                      v_head_dim=16)):
        mine = transformer.param_defs(dataclasses.replace(cfg, **over))
        ref = jregistry.get_reduced("tinyllama-1.1b", **over).param_defs()
        flat = {jax.tree_util.keystr(path): d for path, d in
                jax.tree_util.tree_flatten_with_path(
                    mine, is_leaf=lambda d: not isinstance(d, dict))[0]}
        jflat = {jax.tree_util.keystr(path): d for path, d in
                 jax.tree_util.tree_flatten_with_path(
                     ref, is_leaf=lambda d: hasattr(d, "spec"))[0]}
        assert set(flat) == set(jflat)
        for name, d in flat.items():
            assert d.shape == jflat[name].shape, name
            want = torch.float32 if jflat[name].dtype == jnp.float32 \
                else torch.bfloat16
            assert d.dtype == want, name
        if over.get("mla"):
            assert set(mine["layers"]["attn"]) == {
                "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}


def test_params_from_numpy_carries_the_moe_and_mla_trees():
    """DeepSeek's tree (MLA's seven weights, the f32 router, the shared
    experts) crosses with each weight's own dtype; a tree without the
    shared experts is refused."""
    api = registry.get_reduced("deepseek-v2-236b")
    tree = jax.tree.map(np.asarray, jregistry.get_reduced(
        "deepseek-v2-236b").init_params(jax.random.key(0)))
    params = params_from_numpy(tree, api.cfg, device="cpu")
    ffn = params["layers"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["shared"]["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ffn["router"].numpy(),
                                  tree["layers"]["ffn"]["router"])
    assert len(params["layers"]["attn"]) == 7
    del tree["layers"]["ffn"]["shared"]
    with pytest.raises(ValueError, match="ffn"):
        params_from_numpy(tree, api.cfg, device="cpu")


def test_graph_decode_step_refuses_cpu_tensors():
    """The graph step needs the card; on the CPU the caller takes
    ``make_decode_step``, and nothing is captured or run."""
    api = registry.get_reduced("tinyllama-1.1b")
    params = api.init_params(0, device="cpu")
    _, cache = api.prefill_fn(
        params, {"tokens": torch.from_numpy(_tokens(85, 1, 4, 256))},
        max_len=8)
    with pytest.raises(ValueError, match="make_decode_step"):
        steps.graph_decode_step(api, params, cache, 1)
    with pytest.raises(ValueError, match="CUDA graph"):
        serve_mod._serve_loop(api, params, batch=1, prompt_len=4, gen_len=1,
                              graph=True)


# what reads a tensor's value back to the host (a sync a CUDA graph
# capture refuses)
_HOST_READS = {"item", "cpu", "nonzero", "tolist", "numpy", "argwhere"}


def test_the_decode_step_reads_nothing_back_to_the_host():
    """No function a decode step runs calls ``.item()``, ``.cpu()``,
    ``nonzero`` or the like, or takes ``int``/``float``/``bool`` of a
    value: the position, the lengths, the cache row, MoE's routing, the
    SSM state and Whisper's position row stay on the device.  (Python ints
    of shapes are no read: the functions take them from ``.shape``, not
    through ``int()``.)"""
    fns = (transformer.decode_fn, transformer.gqa_decode, transformer._qkv,
           transformer.ffn_block, transformer._logits, transformer._layer,
           moe.moe_ffn, moe.route, mla.mla_decode, mla._project_q,
           mla._latent, layers.rmsnorm, layers.apply_rope,
           layers.rope_frequencies, layers.swiglu, layers.embed,
           ops.decode_attention, flash_decode.decode_attention,
           flash_decode.decode_combine,
           # the SSM, hybrid and encoder-decoder decode paths
           mamba_lm.decode_fn, ssm.ssd_decode, ssm._split_proj,
           hybrid.decode_fn, hybrid.shared_block_decode, hybrid._qkv,
           hybrid._mlp, encdec.decode_fn, encdec._embed_at, encdec._heads,
           encdec._norm, encdec._mlp, layers.layernorm, layers.gelu_mlp,
           layers.sinusoidal_positions)
    for fn in fns:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in _HOST_READS, (fn.__name__, node.attr)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name):
                assert node.func.id not in ("int", "float", "bool"), \
                    (fn.__name__, node.func.id)
