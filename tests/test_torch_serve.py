"""The port's serving path against the JAX package, on the CPU, at the
reduced ``tinyllama-1.1b`` (2 layers, d_model 64, 4 heads / 2 KV heads):
the JAX package's ``init_params`` carried across by
``reference_io.params_from_numpy``, then prefill logits and cache and
several teacher-forced decode steps compared.  The port's decode attention
is the decode kernel's plain version (CPU tensors); the reference's is the
dense ``decode_attention_jnp``.

Tolerances, relative to the largest logit of the step.  float32 weights:
``1e-5`` — every product, norm and softmax is f32 on both sides, in
another order; the cache is bf16 on both sides (the reference casts it).
bfloat16 weights: ``3e-2`` — XLA fuses the elementwise ops between the
bf16 products and keeps f32 where PyTorch rounds to bf16 after each op,
so the two differ by a few units of bf16's 2**-8 per layer.  The cache
(bf16 on both sides), relative to its largest entry: float32 weights
``2**-7`` — the same f32 value rounded to bf16 on both sides, so at most
one unit in the last place where the f32 values straddle a rounding
boundary; bfloat16 weights ``3e-2``, as the logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.models import layers, registry, transformer
from repro_torch.models.common import count_params
from repro_torch.obs.counters import COUNTS
from repro_torch.reference_io import params_from_numpy

ARCH = "tinyllama-1.1b"
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
CACHE_TOL = {"float32": 2.0 ** -7, "bfloat16": 3e-2}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(dtype):
    """The reduced arch in both packages, with the JAX package's weights
    (cast to ``dtype``) carried into the port."""
    japi = jregistry.get_reduced(ARCH)
    api = registry.get_reduced(ARCH)
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
def test_prefill_and_teacher_forced_decode_match_jax(dtype):
    japi, jparams, api, params = _both(dtype)
    b, t, n_steps = 2, 8, 4
    toks = _tokens(70, b, t + n_steps, api.cfg.vocab)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :t])},
                             max_len=16)
    tl, tc = api.prefill_fn(params, {"tokens": torch.from_numpy(toks[:, :t])},
                            max_len=16)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _rel(tl.numpy(), jl) <= LOGIT_TOL[dtype]
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].dtype == torch.bfloat16
        assert _rel(tc[name].float().numpy(), jc[name]) <= CACHE_TOL[dtype]
    for pos in range(t, t + n_steps):
        jl, jc = japi.decode_fn(jparams, jc, jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.int32(pos))
        tl, tc = api.decode_fn(params, tc,
                               torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL[dtype], pos
    for name in ("k", "v"):
        assert _rel(tc[name].float().numpy(), jc[name]) <= CACHE_TOL[dtype]


@pytest.mark.parametrize("t", [4, 8, 11])
def test_decode_matches_prefill(t):
    """Decoding token T with the prefill cache == prefilling T+1 tokens
    (``tests/test_models_smoke.py:62-81`` for the reference), within
    ``1e-2`` of the largest logit: the decode kernel's online softmax over
    KV blocks is not bit-equal to prefill's one-chunk softmax, and a
    rounding of the bf16 attention output can flip."""
    api = registry.get_reduced(ARCH)
    params = api.init_params(1, device="cpu")
    toks = torch.from_numpy(_tokens(71, 2, t + 1, api.cfg.vocab))
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :t]}, max_len=16)
    logits_d, _ = api.decode_fn(params, cache, toks[:, t:t + 1], t)
    logits_full, _ = api.prefill_fn(params, {"tokens": toks}, max_len=16)
    assert _rel(logits_d.numpy(), logits_full.numpy()) <= 1e-2


def test_each_decode_step_goes_through_ops_decode_attention(monkeypatch):
    """One call of the decode kernel's entry point per layer per step, on
    the cache as stored (not GQA-repeated); on CPU tensors nothing is
    launched, so the launch counter stays put."""
    api = registry.get_reduced(ARCH)
    cfg = api.cfg
    params = api.init_params(2, device="cpu")
    seen = []
    real = ops.decode_attention

    def spy(q, k, v, lengths=None, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), lengths.tolist()))
        return real(q, k, v, lengths, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    launches = COUNTS["flash_decode"]
    toks = torch.from_numpy(_tokens(72, 3, 6, cfg.vocab))
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :5]}, max_len=9)
    cache_k = cache["k"]
    api.decode_fn(params, cache, toks[:, 5:6], 5)
    assert cache["k"] is cache_k                     # updated in place
    assert bool(cache_k[:, :, 5].abs().sum() > 0)
    # prefill sized the cache to the rows the kernel's plan walks in
    # place (9 -> 16), so decode attends over it as stored
    rows = ops.decode_cache_rows(9, cfg.head_dim,
                                 cfg.n_heads // cfg.n_kv_heads,
                                 3 * cfg.n_kv_heads)
    assert seen == [((3, cfg.n_heads, cfg.head_dim),
                     (3, rows, cfg.n_kv_heads, cfg.head_dim), [6, 6, 6])
                    ] * cfg.n_layers
    assert COUNTS["flash_decode"] == launches


def test_serve_runs_end_to_end_on_the_cpu():
    run = serve_mod.serve(ARCH, batch=2, prompt_len=8, gen_len=3,
                          device="cpu")
    assert run.tokens.shape == (2, 3)
    cfg = registry.get_reduced(ARCH).cfg
    assert 0 <= run.tokens.min() and run.tokens.max() < cfg.padded_vocab
    assert run.prefill_ms > 0 and run.decode_ms_per_step > 0
    again = serve_mod.serve(ARCH, batch=2, prompt_len=8, gen_len=3,
                            device="cpu")
    np.testing.assert_array_equal(run.tokens, again.tokens)   # seeded


def test_serve_main_prints_the_shape(capsys):
    serve_mod.main(["--batch", "1", "--prompt-len", "4", "--gen-len", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tokens/s" in out and "(1, 2)" in out


@pytest.mark.parametrize("bad", [dict(batch=0), dict(prompt_len=0),
                                 dict(gen_len=0)])
def test_serve_config_errors(bad):
    with pytest.raises(serve_mod.ServeConfigError):
        serve_mod.serve(ARCH, device="cpu", **bad)


def test_serve_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve(ARCH, gen_len=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.get_reduced(ARCH).init_params(0)


def test_registry_lists_only_what_is_ported():
    """Every id of the JAX package's registry, in its order: the seven it
    maps to its transformer module, Mamba2's SSM, Zamba2's hybrid and
    Whisper's encoder-decoder; none raises "not ported yet"."""
    assert len(jregistry.ARCH_IDS) == 10
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    for arch in registry.ARCH_IDS:
        api = registry.get(arch)
        assert api.module.__name__.rsplit(".", 1)[1] == \
            jregistry.get(arch).module.__name__.rsplit(".", 1)[1]
    with pytest.raises(KeyError, match="tinyllama-1.1b") as err:
        registry.get("no-such-arch")
    assert "not ported" not in str(err.value)


def test_the_full_config_is_the_reference_config():
    cfg = registry.get(ARCH).cfg
    jcfg = jregistry.get(ARCH).cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == (22, 2048, 32, 4, 5632, 32000)
    from repro.models.common import count_params as jcount
    assert count_params(transformer.param_defs(cfg)) == \
        jcount(jregistry.get(ARCH).param_defs()) == 1_100_048_384
    assert dataclasses.asdict(registry.get_reduced(ARCH).cfg) == \
        dataclasses.asdict(jregistry.get_reduced(ARCH).cfg)


def test_init_params_is_seeded_and_shaped():
    api = registry.get_reduced(ARCH)
    a = api.init_params(3, device="cpu")
    b = api.init_params(3, device="cpu")
    c = api.init_params(4, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"]["ffn"]["w_up"].shape == (2, 64, 128)
    assert a["layers"]["ffn"]["w_up"].dtype == torch.bfloat16
    assert bool((a["ln_f"] == 1).all())
    cache = api.cache_defs(2, 16)
    assert cache["k"].shape == (2, 2, 16, 2, 16)


def test_params_from_numpy_refuses_another_tree():
    api = registry.get_reduced(ARCH)
    tree = jax.tree.map(np.asarray, jregistry.get_reduced(ARCH).init_params(
        jax.random.key(0)))
    tree["ln_f"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="ln_f"):
        params_from_numpy(tree, api.cfg, device="cpu")
    del tree["ln_f"]
    with pytest.raises(ValueError, match="want keys"):
        params_from_numpy(tree, api.cfg, device="cpu")


def test_step_functions_are_the_model_functions():
    api = registry.get_reduced(ARCH)
    params = api.init_params(5, device="cpu")
    toks = torch.from_numpy(_tokens(73, 1, 5, api.cfg.vocab))
    logits, cache = steps.make_prefill_step(api, max_len=8)(
        params, {"tokens": toks[:, :4]})
    want, _ = api.prefill_fn(params, {"tokens": toks[:, :4]}, max_len=8)
    assert torch.equal(logits, want)
    assert cache["k"].shape[2] == transformer.cache_rows(api.cfg, 1, 8)
    logits, _ = steps.make_decode_step(api)(params, cache, toks[:, 4:], 4)
    assert logits.shape == (1, api.cfg.padded_vocab)


def test_flash_attention_over_several_chunks_matches_jax():
    """Query and KV chunks smaller than the sequence, a prefill
    continuation offset: the chunked online softmax equals the JAX
    package's, float32 (``1e-5``: the same f32 arithmetic in another
    order)."""
    rng = np.random.default_rng(74)
    q, k, v = (rng.standard_normal((2, 11, 4, 8)).astype(np.float32)
               for _ in range(3))
    for causal, offset in ((True, 0), (True, 5), (False, 0)):
        got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     q_offset=offset, q_chunk=4, kv_chunk=3)
        want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       q_offset=offset, q_chunk=4, kv_chunk=3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_decode_kernel_path_matches_the_dense_decode_attention():
    """The decode kernel's plain version on the un-repeated cache, the
    port's dense counterpart of ``decode_attention_jnp`` on the repeated
    one, and the JAX function itself agree (float32, ``1e-5``: one softmax
    against an online one over KV blocks)."""
    rng = np.random.default_rng(75)
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    lengths = np.array([1, 17, 40], np.int32)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lengths),
                               bkv=16)
    dense = layers.decode_attention_dense(
        torch.from_numpy(q), layers.repeat_kv(torch.from_numpy(k), 4),
        layers.repeat_kv(torch.from_numpy(v), 4), torch.from_numpy(lengths))
    want = jlayers.decode_attention_jnp(
        jnp.asarray(q), jlayers.repeat_kv(jnp.asarray(k), 4),
        jlayers.repeat_kv(jnp.asarray(v), 4), jnp.asarray(lengths))
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
