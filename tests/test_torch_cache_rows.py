"""Serving caches sized so that the decode kernel reads them in place.

Prefill gives every GQA cache (the transformer ids' and Zamba2's shared
block's) ``ops.decode_cache_rows`` rows: the caller's ``max_len`` rounded
up to the rows the kernel's plan walks, so no decode step pads (copies)
the cache, as the JAX package's ``decode_attention_jnp`` reads its cache
in place.  The rows past ``max_len`` are zero and the lengths mask hides
them, so the logits are those of a cache of exactly ``max_len`` rows,
which ``ops.decode_attention`` pads on every step, bit for bit.  Checked
at 32 + 17 = 49 and 480 + 8 = 488 rows, batch 4, on the CPU (the kernel's
plain version, same plan): lengths off the plan's grain of 16 rows a range
(the serve CLI's default, 32 + 16, lies on it and needs no padding)."""
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import hybrid, registry, transformer

GQA_IDS = ("tinyllama-1.1b", "qwen2-7b", "qwen2.5-14b", "qwen2.5-32b",
           "chameleon-34b", "dbrx-132b", "zamba2-2.7b")
BATCH = 4


def _kv(api, cache):
    return cache["attn"] if api.cfg.family == "hybrid" else cache


def _run(api, params, toks, t_p, max_len, steps):
    """Prefill ``t_p`` tokens, then ``steps`` teacher-forced decode steps;
    returns (the cache, every step's logits, the copies ``ops._pad_to``
    made during the decode steps)."""
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :t_p]},
                              max_len=max_len)
    copies = []
    real = ops._pad_to

    def counting(x, axis, mult):
        y = real(x, axis, mult)
        if y is not x:
            copies.append(tuple(x.shape))
        return y

    logits = []
    ops._pad_to = counting
    try:
        for pos in range(t_p, t_p + steps):
            logits.append(api.decode_fn(params, cache,
                                        toks[:, pos:pos + 1], pos)[0])
    finally:
        ops._pad_to = real
    return cache, logits, copies


@pytest.mark.parametrize("t_p,gen", [(32, 17), (480, 8)])
@pytest.mark.parametrize("arch", GQA_IDS)
def test_a_decode_step_copies_no_cache(monkeypatch, arch, t_p, gen):
    api = registry.get_reduced(arch)
    cfg = api.cfg
    params = api.init_params(7, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(t_p).integers(
        0, cfg.vocab, size=(BATCH, t_p + 2)))
    max_len = t_p + gen
    cache, logits, copies = _run(api, params, toks, t_p, max_len, 2)
    rows = ops.decode_cache_rows(max_len, cfg.head_dim,
                                 cfg.n_heads // cfg.n_kv_heads,
                                 BATCH * cfg.n_kv_heads, 2)
    assert rows > max_len          # both lengths are off the plan's grain
    assert _kv(api, cache)["k"].shape[2] == rows
    assert bool((_kv(api, cache)["k"][:, :, t_p + 2:] == 0).all())
    assert copies == []
    # the parent's cache of exactly max_len rows, padded by every step
    exact = lambda cfg_, b, m: m                              # noqa: E731
    monkeypatch.setattr(transformer, "cache_rows", exact)
    monkeypatch.setattr(hybrid, "cache_rows", exact)
    cache0, logits0, copies0 = _run(api, params, toks, t_p, max_len, 2)
    assert _kv(api, cache0)["k"].shape[2] == max_len
    assert len(copies0) == 2 * 2 * (cfg.n_layers // cfg.attn_every
                                    if cfg.attn_every else cfg.n_layers)
    for a, b in zip(logits, logits0, strict=True):
        assert torch.equal(a, b)
    for name in ("k", "v"):
        assert torch.equal(_kv(api, cache)[name][:, :, :max_len],
                           _kv(api, cache0)[name])


def test_mla_caches_keep_max_len_rows():
    """DeepSeek-V2's latent cache is not read by the decode kernel."""
    api = registry.get_reduced("deepseek-v2-236b")
    params = api.init_params(7, device="cpu")
    toks = torch.zeros((BATCH, 5), dtype=torch.int64)
    _, cache = api.prefill_fn(params, {"tokens": toks}, max_len=21)
    assert cache["c_kv"].shape[2] == cache["k_pe"].shape[2] == 21
    assert transformer.cache_rows(api.cfg, BATCH, 21) == 21


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_serving_at_the_cli_defaults_is_unchanged(monkeypatch, arch):
    """The serve loop at its CLI's defaults (batch 4, 32 + 16) generates
    the tokens of a run over exact-length caches, and never decodes past
    the caller's ``max_len - 1``."""
    api = registry.get_reduced(arch)
    params = api.init_params(0, device="cpu")
    seen = []
    real = api.module.decode_fn

    def spy(params_, cache, tokens, pos, cfg, axes=None):
        seen.append(int(pos))
        return real(params_, cache, tokens, pos, cfg, axes)

    monkeypatch.setattr(api.module, "decode_fn", spy)
    run = serve_mod._serve_loop(api, params, batch=4, prompt_len=32,
                                gen_len=16)
    assert max(seen) == 32 + 16 - 1
    exact = lambda cfg_, b, m: m                              # noqa: E731
    monkeypatch.setattr(transformer, "cache_rows", exact)
    monkeypatch.setattr(hybrid, "cache_rows", exact)
    run0 = serve_mod._serve_loop(api, params, batch=4, prompt_len=32,
                                 gen_len=16)
    assert np.array_equal(run.tokens, run0.tokens)
