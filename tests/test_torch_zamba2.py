"""Zamba2 as published (``models/zamba2.py``) against the plain reference
``bench/reference/zamba2.py`` (plain torch, float32, loaded by path: it
imports nothing of the port), on the CPU, at a small size that keeps the
structure: d 64, 8 layers, Mamba-2 heads of 16 with B and C in 2 groups,
both shared blocks applied twice (layers 1, 3, 5, 7), attention heads of
2d / 4 = 32, adapters of rank 8 (``Zamba2Config.reduced``).  The weights
are the port's seeded ``init_params`` in float32, with the per-head
constants drawn as a trained model has them (A from 1..16, dt from
1e-3..1e-1, D about 1, conv biases), the same tensors for both.

Tolerances, relative to the largest reference logit (or state):

- ``FULL_TOL`` 2e-5: the full-sequence form in float32 computes the same
  sums in another order (the chunked SSD scan's quadratic form and carried
  chunk states against the reference's step-by-step recurrence); read
  1.5e-6.
- ``CHAIN_TOL`` 1e-2: prefill through the chunked scan, then decode steps
  through the port's own cache, which stores the KV rows and the conv
  window in bfloat16: entries rounded by up to 2**-9 of themselves, which
  moved the logits by 3.8e-3 here.
- ``DECODE_TOL`` 1e-4: decode steps from the reference's own float32 state
  after the prompt, in a float32 cache: another order of sums again, and
  K5's plain version's online softmax, over 7 steps whose errors
  compound.
- ``STEP_TOL`` 1e-5: one recurrent step of the mixer, float32 both.

The reference run with its recurrent state rounded to bfloat16 between
steps (the control) misses ``DECODE_TOL`` by more than ten times: these
tolerances see the precision the configuration states.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.models import registry, ssm, zamba2
from repro_torch.models.common import init_params, map_defs
from repro_torch.models.layers import rmsnorm
from repro_torch.models.transformer import _layer, cache_rows

ROOT = pathlib.Path(__file__).resolve().parent.parent
FULL_TOL = 2e-5
CHAIN_TOL = 1e-2
DECODE_TOL = 1e-4
STEP_TOL = 1e-5
PROMPT, STEPS = 24, 8


def load_reference():
    spec = importlib.util.spec_from_file_location(
        "zamba2_reference", ROOT / "bench" / "reference" / "zamba2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = load_reference()


def model_dict(cfg) -> dict:
    """The configuration under the published config.json's keys."""
    return {"hidden_size": cfg.d_model, "mamba_expand": cfg.ssm_expand,
            "mamba_headdim": cfg.ssm_head_dim,
            "mamba_ngroups": cfg.ssm_groups, "mamba_d_state": cfg.ssm_state,
            "mamba_d_conv": cfg.ssm_conv_width,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.d_ff,
            "num_mem_blocks": cfg.num_mem_blocks,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
            "num_hidden_layers": cfg.n_layers}


def make_params(api, seed: int = 3):
    """The port's seeded weights in float32, the mixers' per-head
    constants drawn as a trained model has them."""
    p = map_defs(lambda t: t.float(), api.init_params(seed, device="cpu"))
    gen = torch.Generator().manual_seed(seed + 100)
    m = p["mamba"]["mixer"]
    m["a_log"].copy_(torch.log(1 + 15 * torch.rand(m["a_log"].shape,
                                                   generator=gen)))
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    dt = torch.exp(lo + (hi - lo) * torch.rand(m["dt_bias"].shape,
                                               generator=gen))
    m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    m["d_skip"].copy_(1 + 0.1 * torch.randn(m["d_skip"].shape,
                                            generator=gen))
    m["conv_b"].copy_(0.1 * torch.randn(m["conv_b"].shape, generator=gen))
    return p


@pytest.fixture(scope="module")
def setup():
    api = registry.get_reduced("zamba2-7b")
    params = make_params(api)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, api.cfg.vocab, (2, PROMPT + STEPS),
                           generator=gen)
    want = REF.forward(params, model_dict(api.cfg), tokens)
    return api, params, tokens, want


def _full_logits(api, params, tokens):
    x, _, _ = zamba2._sequence(params, tokens, api.cfg)
    x = rmsnorm(x, params["ln_f"], api.cfg.norm_eps)
    return x.float() @ params["embed"].t().float()


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _decode(api, params, cache, tokens):
    """Decode tokens PROMPT .. PROMPT + STEPS - 2 through ``cache``: the
    logits of each step, stacked."""
    out = []
    for t in range(STEPS - 1):
        logits, cache = api.decode_fn(
            params, cache, tokens[:, PROMPT + t:PROMPT + t + 1], PROMPT + t)
        out.append(logits)
    return torch.stack(out, dim=1)


def _reference_cache(api, params, tokens):
    """The reference's state after PROMPT tokens, in float32, in the
    port's cache layout."""
    cfg = api.cfg
    run = REF.forward(params, model_dict(cfg), tokens[:, :PROMPT])
    rows = cache_rows(cfg, tokens.shape[0], PROMPT + STEPS)
    cache = map_defs(lambda t: t.float(), init_params(
        api.cache_defs(tokens.shape[0], rows), device="cpu"))
    cache["mamba"]["h"].copy_(torch.stack(run["h"]))
    cache["mamba"]["conv"].copy_(torch.stack(run["conv"]))
    for name in ("k", "v"):
        cache["attn"][name][:, :, :PROMPT] = torch.stack(run[name])
    return cache


def test_the_registry_serves_the_published_layout():
    api = registry.get("zamba2-7b")
    cfg = api.cfg
    assert "zamba2-7b" in registry.SERVED_IDS
    assert "zamba2-7b" not in registry.ARCH_IDS
    assert api.module is zamba2
    assert not api.meshed and registry.get("mamba2-2.7b").meshed
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_groups,
            cfg.head_dim, cfg.d_ff, zamba2.n_apps(cfg)) == \
        (81, 3584, 112, 2, 224, 14336, 13)
    assert zamba2.attn_scale(cfg) == pytest.approx(112 ** -0.5)


def test_the_full_sequence_logits_match_the_reference(setup):
    api, params, tokens, want = setup
    err = _rel(_full_logits(api, params, tokens), want["logits"])
    assert err < FULL_TOL, err


def test_prefill_then_decode_match_the_full_forward_pass(setup):
    """Through the port's own cache as it stores it: the prefill's last
    logits, then every decode step's, and every application's KV rows."""
    api, params, tokens, want = setup
    logits, cache = api.prefill_fn(params, {"tokens": tokens[:, :PROMPT]},
                                   max_len=PROMPT + STEPS)
    got = torch.cat([logits[:, None], _decode(api, params, cache, tokens)],
                    dim=1)
    err = _rel(got, want["logits"][:, PROMPT - 1:PROMPT + STEPS - 1])
    assert err < CHAIN_TOL, err
    for j in range(zamba2.n_apps(api.cfg)):
        for name in ("k", "v"):
            rows = cache["attn"][name][j, :, :PROMPT + STEPS - 1].float()
            assert _rel(rows, want[name][j][:, :PROMPT + STEPS - 1]) < \
                CHAIN_TOL


def test_decode_steps_from_the_reference_state_match_it(setup):
    """Teacher-forced from the reference's own float32 state after the
    prompt (as the benchmark's check runs): the steps alone; the
    reference with its state through bfloat16 misses by ten times."""
    api, params, tokens, want = setup
    cache = _reference_cache(api, params, tokens)
    got = _decode(api, params, cache, tokens)
    ref_logits = want["logits"][:, PROMPT:PROMPT + STEPS - 1]
    assert _rel(got, ref_logits) < DECODE_TOL
    # the states after the last step: the reference's after one token less
    last = REF.forward(params, model_dict(api.cfg), tokens[:, :-1])
    assert _rel(cache["mamba"]["h"], torch.stack(last["h"])) < DECODE_TOL
    control = REF.forward(params, model_dict(api.cfg), tokens,
                          state_dtype=torch.bfloat16)
    c_err = _rel(control["logits"][:, PROMPT:PROMPT + STEPS - 1],
                 ref_logits)
    assert c_err > 10 * DECODE_TOL, c_err


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_one_recurrent_step_matches_the_reference(groups):
    """``ssm.ssd_decode`` (``_ssd_step``): head h reads group
    h // (heads / groups), the gated norm runs by group."""
    api = registry.get_reduced("zamba2-7b")
    cfg = dataclasses.replace(api.cfg, ssm_groups=groups)
    api = registry.ModelApi(cfg=cfg, module=zamba2)
    params = make_params(api, seed=5)
    lp = _layer(params["mamba"], 0)
    gen = torch.Generator().manual_seed(17)
    b = 3
    conv = cfg.d_inner + 2 * groups * cfg.ssm_state
    h0 = torch.randn((b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                     generator=gen)
    w0 = torch.randn((b, cfg.ssm_conv_width - 1, conv), generator=gen)
    u = torch.randn((b, 1, cfg.d_model), generator=gen)
    cache = {"h": h0.clone(), "conv": w0.clone()}
    got = ssm.ssd_decode(u, lp["mixer"], cfg, cache)
    s = REF.sizes(dict(model_dict(cfg), mamba_ngroups=groups))
    mp = REF._pick(params["mamba"], 0, None)["mixer"]
    want, h, window = REF._mixer(u, mp, s, (h0, w0), None)
    assert _rel(got, want) < STEP_TOL
    assert _rel(cache["h"], h) < STEP_TOL
    assert _rel(cache["conv"], window) < STEP_TOL


def test_the_blocks_alternate_and_each_application_has_its_adapter(setup):
    api, params, tokens, _ = setup
    base = _full_logits(api, params, tokens)

    def changed(edit):
        p = map_defs(lambda t: t.clone(), params)
        edit(p)
        return not torch.equal(_full_logits(api, p, tokens), base)

    def swap_adapters(p, i, j):
        for name in ("adapter_in", "adapter_out"):
            t = p["apps"][name]
            t[i], t[j] = t[j].clone(), t[i].clone()

    # applications 0 and 2 both use block 0: their adapters are their own
    assert changed(lambda p: swap_adapters(p, 0, 2))
    # application 1 uses block 1: with block 1's o_proj zero its output
    # is zero whatever its linear map, while application 0's is not
    def zero_block1(p):
        p["blocks"]["wo"][1].zero_()

    def scale_linear(j):
        def edit(p):
            zero_block1(p)
            p["apps"]["linear"][j].mul_(3.0)
        return edit

    p1 = map_defs(lambda t: t.clone(), params)
    zero_block1(p1)
    base_zero = _full_logits(api, p1, tokens)
    for j, moves in ((0, True), (1, False), (2, True), (3, False)):
        p = map_defs(lambda t: t.clone(), params)
        scale_linear(j)(p)
        assert (not torch.equal(_full_logits(api, p, tokens), base_zero)) \
            is moves, j


def test_the_injection_goes_into_the_mixer_input_not_the_residual(setup):
    """With the mixer of hybrid layer 3 silenced (its ``out_proj`` zero),
    what application 1 adds cannot reach the output: it enters only that
    mixer's input.  With the mixer live it does."""
    api, params, tokens, _ = setup
    layer = api.cfg.hybrid_layer_ids[1]

    def logits(silence: bool, scale: float):
        p = map_defs(lambda t: t.clone(), params)
        if silence:
            p["mamba"]["mixer"]["out_proj"][layer].zero_()
        p["apps"]["linear"][1].mul_(scale)
        return _full_logits(api, p, tokens)

    assert torch.equal(logits(True, 1.0), logits(True, 5.0))
    assert not torch.equal(logits(False, 1.0), logits(False, 5.0))
