"""The port's SSM, hybrid and encoder-decoder families against the JAX
package, on the CPU, at the reduced configs (``get_reduced``: 2 layers,
d_model 64; Mamba2 and Zamba2 with SSM state 16, heads of 16, chunk 8,
Zamba2's shared block after 2 layers with 4 heads of 16; Whisper 2 + 2
layers, 4 heads, dec_seq 16): the JAX package's own ``init_params``
carried across by ``reference_io.params_from_numpy``, inputs drawn with
numpy from a seed, then prefill, decode steps and the layers compared.

Tolerances, relative to the largest entry.  Logits and caches:
``test_torch_serve.py``'s ``LOGIT_TOL`` and ``CACHE_TOL`` (their reasons
are stated there; float32 ``1e-5``, bfloat16 ``3e-2``).  The SSM state
``h`` is float32 in both dtypes: ``H_TOL`` float32 ``1e-5`` (f32 sums of
the same terms in another order: the port's einsums against XLA's), and
bfloat16 ``3e-2`` (the state is summed in f32 from ``x``, ``B`` and
``dt`` that come out of bf16 projections and elementwise ops, which
differ by a few units of bf16's 2**-8 between the two packages, as the
logits do).

A decode step of Zamba2 or Whisper writes this token's K and V row in
bfloat16 and attends over it in the same step: where the two packages'
float32 values of an entry straddle a bf16 rounding boundary, that entry
moves by 2**-8 of itself (5.7e-3 of the largest V at Zamba2's second
step), which moves the logits by about 7e-5 of the largest.  Their steps
take ``STEP_TOL``: float32 ``1e-4``, bfloat16 ``LOGIT_TOL``'s.

Teacher-forced decode steps start both packages from the same cache: the
JAX package's cache, cast to the port's dtypes, is written into the
port's before each step.  The conv tail is stored in bfloat16, so a
difference in the last f32 bit before that rounding can move a stored
value by 2**-8 of itself; chaining each package's own cache would compare
those roundings, not the step.  (The JAX package's decode also promotes
its bf16 conv tail to the activations' dtype, float32 in the float32
case; the port keeps the one bf16 buffer a CUDA graph writes.)  Decode
against the port's own prefill takes the JAX test's tolerance for the SSD
families (``tests/test_models_smoke.py:78-81``, ``0.02``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import fast_polish_port  # noqa: F401
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import encdec, layers, registry, ssm, transformer
from repro_torch.reference_io import params_from_numpy
from test_torch_serve import CACHE_TOL, LOGIT_TOL

IDS = ("mamba2-2.7b", "zamba2-2.7b", "whisper-medium")
SSD_IDS = ("mamba2-2.7b", "zamba2-2.7b")
H_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
STEP_TOL = {"float32": 1e-4, "bfloat16": LOGIT_TOL["bfloat16"]}
SSD_REL_TOL = 0.02          # tests/test_models_smoke.py:78-81
# Whisper's decode chain against its teacher-forced decoder, both the
# port's, bf16 weights: the same bf16 products per row, but self-attention
# is one causal flash pass in ``decode_train`` and the decode kernel's
# plain version (blocks of the planner's bkv, split then combined) over
# the cache in the chain, so the bf16 attention outputs can round apart
# by a unit in the last place; 1e-2 of the largest logit.
WHISPER_CHAIN_TOL = 1e-2
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(arch, dtype):
    """The reduced arch in both packages, with the JAX package's weights
    (cast to ``dtype``) carried into the port."""
    japi = jregistry.get_reduced(arch)
    api = registry.get_reduced(arch)
    jparams = japi.init_params(jax.random.key(1))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jparams), api.cfg, device="cpu",
        dtype=torch.float32 if dtype == "float32" else None)
    return japi, jparams, api, params


def _pairs(tc, jc):
    """(name, the port's leaf cut to the reference's shape, the reference's
    leaf) over the reference's cache tree; the port's padded cross cache
    is cut to the reference's rows."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        t = tc
        for key in path:
            t = t[key.key]
        leaf = np.asarray(leaf)
        yield ("/".join(key.key for key in path),
               t[tuple(slice(0, n) for n in leaf.shape)], leaf)


def _check_cache(tc, jc, dtype, where):
    for name, t, leaf in _pairs(tc, jc):
        state = name.split("/")[-1] == "h"
        assert t.shape == leaf.shape, (where, name)
        tol = H_TOL[dtype] if state else CACHE_TOL[dtype]
        assert t.dtype == (torch.float32 if state else torch.bfloat16), \
            (where, name)
        assert _rel(t.float().numpy(), leaf) <= tol, (where, name)


def _same_state(tc, jc):
    """The reference's cache cast to the port's leaf dtypes, also written
    into the port's cache: both packages then step from one state."""
    out = {}
    for name, t, leaf in _pairs(tc, jc):
        t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
        # a copy: a JAX array on the CPU may alias the numpy buffer, which
        # the port's step then rewrites in place
        out[name] = jnp.array(np.array(t.float().numpy())).astype(
            jnp.float32 if t.dtype == torch.float32 else jnp.bfloat16)
    leaves = [out[name] for name, _, _ in _pairs(tc, jc)]
    return jax.tree.unflatten(jax.tree.structure(jc), leaves)


def _prefill_inputs(api, dtype, seed, b, t):
    """The prefill batch of both packages: Whisper's frames (in the
    weights' dtype: the JAX encoder's scan keeps its carry's dtype) or
    token prompts."""
    rng = np.random.default_rng(seed)
    if api.cfg.family == "audio":
        frames = rng.standard_normal((b, t, api.cfg.d_model)
                                     ).astype(np.float32)
        return ({"frames": jnp.asarray(frames).astype(
                    jnp.float32 if dtype == "float32" else jnp.bfloat16)},
                {"frames": torch.from_numpy(frames).to(TORCH_DTYPE[dtype])})
    toks = rng.integers(0, api.cfg.vocab, size=(b, t))
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", IDS)
def test_prefill_and_teacher_forced_decode_match_jax(arch, dtype):
    """Prefill logits and cache, then three teacher-forced decode steps
    (logits and cache after each), against the JAX package.  SSD prompts
    of 8 tokens fill one chunk (a padded prompt is the next test's);
    Whisper encodes 16 frames and decodes from position 1."""
    japi, jparams, api, params = _both(arch, dtype)
    b, t = 2, 8 if api.cfg.family != "audio" else 16
    jbatch, batch = _prefill_inputs(api, dtype, 90, b, t)
    jl, jc = japi.prefill_fn(jparams, jbatch, max_len=16)
    tl, tc = api.prefill_fn(params, batch, max_len=16)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _rel(tl.numpy(), jl) <= LOGIT_TOL[dtype]
    _check_cache(tc, jc, dtype, "prefill")
    start = 1 if api.cfg.family == "audio" else t
    step_tol = LOGIT_TOL if api.cfg.family == "ssm" else STEP_TOL
    toks = np.random.default_rng(91).integers(0, api.cfg.vocab, size=(b, 3))
    for i, pos in enumerate(range(start, start + 3)):
        jc = _same_state(tc, jc)
        tok = toks[:, i:i + 1]
        jl, jc = japi.decode_fn(jparams, jc, jnp.asarray(tok),
                                jnp.int32(pos))
        tl, tc = api.decode_fn(params, tc, torch.from_numpy(tok), pos)
        assert _rel(tl.numpy(), jl) <= step_tol[dtype], pos
        _check_cache(tc, jc, dtype, pos)


@pytest.mark.parametrize("t", [5, 8, 13])
@pytest.mark.parametrize("arch", SSD_IDS)
def test_decode_matches_prefill(arch, t):
    """Decoding token T with the prefill cache == prefilling T+1 tokens,
    the JAX test's case (b 2, 16 rows, T 8) on the port's own bf16
    weights, within its 0.02; also at T = 5 and 13, where the prompt is
    padded to the chunk (8) and the conv tail must be the real tokens'."""
    api = registry.get_reduced(arch)
    params = api.init_params(1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(92).integers(
        0, api.cfg.vocab, size=(2, t + 1)))
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :t]}, max_len=16)
    logits_d, _ = api.decode_fn(params, cache, toks[:, t:t + 1], t)
    logits_full, _ = api.prefill_fn(params, {"tokens": toks}, max_len=16)
    assert _rel(logits_d.numpy(), logits_full.numpy()) <= SSD_REL_TOL + 1e-6


@pytest.mark.parametrize("arch", SSD_IDS)
def test_the_reference_decodes_a_padded_prompt_from_the_pads_conv_tail(arch):
    """ROADMAP.md Queue 3: after a 5-token prompt (padded to the chunk of
    8) the JAX package's decode convolves the pad's inputs, so it is at
    least half the largest logit away from its own prefill of the same
    tokens; the port's, on the same weights, is within 0.02."""
    japi, jparams, api, params = _both(arch, "bfloat16")
    toks = np.random.default_rng(101).integers(0, api.cfg.vocab, size=(2, 6))
    rel = []
    for prefill, decode, wrap, w in (
            (japi.prefill_fn, japi.decode_fn, jnp.asarray, jparams),
            (api.prefill_fn, api.decode_fn, torch.from_numpy, params)):
        _, cache = prefill(w, {"tokens": wrap(toks[:, :5])}, max_len=16)
        logits_d, _ = decode(w, cache, wrap(toks[:, 5:]), 5)
        logits_f, _ = prefill(w, {"tokens": wrap(toks)}, max_len=16)
        rel.append(_rel(np.asarray(logits_d), np.asarray(logits_f)))
    assert rel[0] >= 0.5 and rel[1] <= SSD_REL_TOL, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_padded_prompt_gives_the_unpadded_prompts_state(dtype):
    """One SSD layer over 5 real positions padded to the chunk of 8, with
    the mask, against the JAX package's layer over the 5 positions alone
    (its chunk then is 5): the same output there, the same state ``h``
    (``dt`` is 0 at the pad) and the same conv tail, the last 3 real
    positions' inputs.  The JAX package's own padded prefill keeps the
    pad's inputs as the tail, so its decode after a prompt that is not a
    multiple of the chunk convolves them (ROADMAP.md Queue 3); the port's
    does not."""
    japi, jparams, api, params = _both("mamba2-2.7b", dtype)
    cfg = api.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mixer"])
    p = {name: w[0] for name, w in params["layers"]["mixer"].items()}
    x = np.random.default_rng(93).standard_normal((2, 5, cfg.d_model)
                                                  ).astype(np.float32)
    xt = torch.from_numpy(x).to(TORCH_DTYPE[dtype])
    xpad = torch.cat([xt, torch.zeros(2, 3, cfg.d_model, dtype=xt.dtype)], 1)
    mask = torch.arange(8)[None].expand(2, 8) < 5
    out, cache = ssm.ssd_forward(xpad, p, cfg, return_cache=True,
                                 seq_mask=mask)
    jout, jcache = jssm.ssd_forward(jnp.asarray(xt.float().numpy()).astype(
        jparams["embed"].dtype), jp, japi.cfg, None, return_cache=True)
    assert _rel(out[:, :5].float().numpy(), jout) <= LOGIT_TOL[dtype]
    assert _rel(cache["h"].numpy(), jcache["h"]) <= H_TOL[dtype]
    assert cache["conv"].dtype == torch.bfloat16
    assert _rel(cache["conv"].float().numpy(), jcache["conv"]) \
        <= CACHE_TOL[dtype]


def test_the_ssd_gradients_stay_finite_at_the_published_chunk():
    """One SSD layer of the reduced Mamba2 at the published chunk of 256
    tokens, float32: a chunk's decay, summed over its tokens, passes
    float32's exponent range above the diagonal, where the decay is
    masked to 0.  The output and every gradient stay finite (the masked
    exponents are -inf, not exp'd and then zeroed: 0 * inf would be NaN
    in the backward), and the output equals the chunk of 8's."""
    api = registry.get_reduced("mamba2-2.7b", ssm_chunk=256)
    cfg = api.cfg
    params = api.init_params(5, device="cpu")
    p = {name: w[0].float().requires_grad_()
         for name, w in params["layers"]["mixer"].items()}
    x = torch.from_numpy(np.random.default_rng(95).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32)).requires_grad_()
    out = ssm.ssd_forward(x, p, cfg)
    grads = torch.autograd.grad(out.square().sum(), [x, *p.values()])
    assert torch.isfinite(out).all()
    for name, g in zip(["x", *p], grads):
        assert torch.isfinite(g).all(), name
    short = ssm.ssd_forward(x, p, dataclasses.replace(cfg, ssm_chunk=8))
    assert _rel(out.detach().numpy(), short.detach().numpy()) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_forward_equals_the_recurrent_decode(dtype):
    """``ssd_forward`` over 16 tokens (two chunks of 8), and over the same
    tokens in two calls with the first call's cache streamed into the
    second, against ``ssd_decode`` run token by token from an empty cache:
    the outputs, the state and the conv tail agree.  float32 (the conv
    tail held in float32 here, so no bf16 rounding enters the recurrence):
    ``1e-4`` of the largest entry, the two forms sum the same f32 terms in
    another order through exp-decays; bfloat16: ``3e-2``, as the logits.
    The streamed tail is stored in bf16, as the JAX package stores it, so
    in float32 the second call convolves rounded inputs: its outputs
    within ``CACHE_TOL``, one bf16 rounding."""
    api = registry.get_reduced("mamba2-2.7b")
    cfg = api.cfg
    params = api.init_params(4, device="cpu")
    dt = TORCH_DTYPE[dtype]
    p = {name: (w[0] if w.dtype == torch.float32 else w[0].to(dt))
         for name, w in params["layers"]["mixer"].items()}
    x = torch.from_numpy(np.random.default_rng(94).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(dt)
    out, cache = ssm.ssd_forward(x, p, cfg, return_cache=True)
    first, c1 = ssm.ssd_forward(x[:, :8], p, cfg, return_cache=True)
    second, c2 = ssm.ssd_forward(x[:, 8:], p, cfg, cache=c1,
                                 return_cache=True)
    state = ssm.ssm_init_cache(cfg, 2, dtype=dt, device="cpu")
    steps = torch.cat([ssm.ssd_decode(x[:, i:i + 1], p, cfg, state)
                       for i in range(16)], dim=1)
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert _rel(steps.float().numpy(), out.float().numpy()) <= tol
    assert _rel(state["h"].numpy(), cache["h"].numpy()) <= tol
    # the chunked form's tail is stored in bf16: one rounding apart
    assert _rel(state["conv"].float().numpy(),
                cache["conv"].float().numpy()) <= CACHE_TOL[dtype]
    assert _rel(torch.cat([first, second], 1).float().numpy(),
                out.float().numpy()) <= max(tol, CACHE_TOL[dtype])
    assert _rel(c2["h"].numpy(), cache["h"].numpy()) <= tol
    assert torch.equal(c2["conv"], cache["conv"])


def test_whisper_decode_chain_matches_jax_step_by_step():
    """The JAX package's ``test_whisper_decode_chain`` (reduced Whisper,
    ``init_params(key 0)``, frames ``normal(key 3)`` (2, 16, d) in bf16,
    prefill, then token 1 at positions 1-4), mirrored on the port from the
    same weights and frames: the BOS logits and each step's logits against
    the reference's, each step from the same cache (the module's note),
    within ``LOGIT_TOL`` bfloat16."""
    japi = jregistry.get_reduced("whisper-medium")
    api = registry.get_reduced("whisper-medium")
    cfg = api.cfg
    jparams = japi.init_params(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    frames = jax.random.normal(jax.random.key(3),
                               (2, 16, cfg.d_model)).astype(jnp.bfloat16)
    jl, jc = japi.prefill_fn(jparams, {"frames": frames})
    tl, tc = api.prefill_fn(params, {"frames": torch.from_numpy(
        np.asarray(frames, np.float32)).to(torch.bfloat16)})
    assert tuple(tl.shape) == (2, cfg.padded_vocab)
    assert _rel(tl.numpy(), jl) <= LOGIT_TOL["bfloat16"]
    ones = np.ones((2, 1), np.int64)
    for pos in range(1, 5):
        jc = _same_state(tc, jc)
        jl, jc = japi.decode_fn(jparams, jc, jnp.asarray(ones),
                                jnp.int32(pos))
        tl, tc = api.decode_fn(params, tc, torch.from_numpy(ones), pos)
        assert bool(torch.isfinite(tl).all())
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL["bfloat16"], pos


def test_whisper_decode_matches_its_teacher_forced_decoder():
    """Prefill (the BOS token at position 0) and four decode steps of the
    port against its own ``decode_train`` over the same tokens on the same
    encoder states, position by position, within ``WHISPER_CHAIN_TOL``;
    and ``decode_train`` against the JAX package's on the same weights."""
    japi, jparams, api, params = _both("whisper-medium", "bfloat16")
    cfg = api.cfg
    jbatch, batch = _prefill_inputs(api, "bfloat16", 95, 2, 16)
    toks = np.random.default_rng(96).integers(0, cfg.vocab, size=(2, 4))
    chain = np.concatenate([np.zeros((2, 1), np.int64), toks], axis=1)
    logits, cache = api.prefill_fn(params, batch)
    steps = [logits]
    for pos in range(1, 5):
        logits, cache = api.decode_fn(
            params, cache, torch.from_numpy(chain[:, pos:pos + 1]), pos)
        steps.append(logits)
    enc_out = encdec.encode(params, batch["frames"], cfg)
    hidden = encdec.decode_train(params, enc_out, torch.from_numpy(chain),
                                 cfg)
    want = hidden.float() @ params["lm_head"].float()
    for pos, got in enumerate(steps):
        assert _rel(got.numpy(), want[:, pos].numpy()) <= WHISPER_CHAIN_TOL, \
            pos
    jhidden = jencdec.decode_train(
        jparams, jencdec.encode(jparams, jbatch["frames"], japi.cfg, None),
        jnp.asarray(chain), japi.cfg, None)
    assert _rel(hidden.float().numpy(), jhidden) <= LOGIT_TOL["bfloat16"]


@pytest.mark.parametrize("arch", IDS)
def test_serve_runs_end_to_end_on_the_cpu(arch):
    run = serve_mod.serve(arch, batch=2, prompt_len=8, gen_len=3,
                          device="cpu")
    cfg = registry.get_reduced(arch).cfg
    assert run.tokens.shape == (2, 3)
    assert 0 <= run.tokens.min() and run.tokens.max() < cfg.padded_vocab
    assert run.capture_ms is None and run.replays == 0      # eager on CPU
    again = serve_mod.serve(arch, batch=2, prompt_len=8, gen_len=3,
                            device="cpu")
    np.testing.assert_array_equal(run.tokens, again.tokens)   # seeded


def test_whisper_past_dec_seq_is_a_config_error():
    """Decoding starts at position 1, so ``gen_len`` may be at most
    ``dec_seq - 1`` (15 at the reduced config): the JAX package clamps the
    write past the last row silently; the port refuses the run."""
    dec_seq = registry.get_reduced("whisper-medium").cfg.dec_seq
    with pytest.raises(serve_mod.ServeConfigError, match="dec_seq"):
        serve_mod.serve("whisper-medium", batch=1, prompt_len=4,
                        gen_len=dec_seq, device="cpu")
    run = serve_mod.serve("whisper-medium", batch=1, prompt_len=4,
                          gen_len=dec_seq - 1, device="cpu")
    assert run.tokens.shape == (1, dec_seq - 1)
    serve_mod.check_serve_config(registry.get_reduced("zamba2-2.7b").cfg,
                                 1, 4, dec_seq)     # only the audio family


def test_serve_main_takes_the_new_ids(capsys):
    for arch in IDS:
        serve_mod.main(["--arch", arch, "--batch", "1", "--prompt-len", "8",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("tokens/s") == 3
    assert "(1, 16)" in out and "(1, 15)" in out       # Whisper: dec_seq 16


@pytest.mark.parametrize("arch", IDS)
def test_configs_and_full_parameter_counts_are_the_reference_ones(arch):
    api, japi = registry.get(arch), jregistry.get(arch)
    assert dataclasses.asdict(api.cfg) == dataclasses.asdict(japi.cfg)
    assert (api.cfg.d_inner, api.cfg.ssm_heads) == \
        (japi.cfg.d_inner, japi.cfg.ssm_heads)
    from repro.models.common import count_params as jcount
    assert api.count_params() == jcount(japi.param_defs())
    want = {"mamba2-2.7b": 2_831_336_960, "zamba2-2.7b": 2_435_777_440,
            "whisper-medium": 811_593_728}
    assert api.count_params() == want[arch]


def test_layers_match_jax():
    """``layernorm``, ``gelu_mlp`` (tanh GELU, ``jax.nn.gelu``'s default)
    and ``sinusoidal_positions`` against the JAX package's, float32
    (``1e-6`` of the largest entry: the same f32 arithmetic), and
    ``layernorm`` in bfloat16 (one rounding apart, ``2**-7``)."""
    rng = np.random.default_rng(97)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal((2, 32)).astype(np.float32)
    got = layers.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b))
    assert _rel(got.numpy(), jlayers.layernorm(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(b))) <= 1e-6
    got = layers.layernorm(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (x, w, b)))
    want = jlayers.layernorm(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2.0 ** -7
    w1, w2 = (rng.standard_normal(s).astype(np.float32) / 6
              for s in ((32, 48), (48, 32)))
    b1, b2 = (rng.standard_normal(n).astype(np.float32) for n in (48, 32))
    got = layers.gelu_mlp(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    want = jlayers.gelu_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    assert _rel(got.numpy(), want) <= 1e-6
    # the same f32 angles; XLA's and PyTorch's sin and cos of angles up to
    # 447 rad agree within 1e-5 (seen 7.6e-6)
    for seq, dim in ((1, 64), (16, 64), (448, 1024)):
        got = layers.sinusoidal_positions(seq, dim)
        assert got.dtype == torch.float32 and got.shape == (seq, dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jlayers.sinusoidal_positions(seq, dim)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", IDS)
def test_params_from_numpy_carries_the_three_trees(arch):
    """Mamba2's, Zamba2's and Whisper's trees cross with each weight's own
    dtype (the SSM's ``a_log``, ``d_skip`` and ``dt_bias`` float32, the
    rest bfloat16) and values; a tree missing a key, or with a leaf of
    another shape, is refused."""
    api = registry.get_reduced(arch)
    tree = jax.tree.map(np.asarray, jregistry.get_reduced(arch).init_params(
        jax.random.key(0)))
    params = params_from_numpy(tree, api.cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        got = params
        for key in path:
            got = got[key.key]
        want = torch.float32 if leaf.dtype == np.float32 else torch.bfloat16
        assert got.dtype == want, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))
    if arch != "whisper-medium":
        stack = "layers" if arch == "mamba2-2.7b" else "mamba"
        assert params[stack]["mixer"]["a_log"].dtype == torch.float32
        tree[stack]["mixer"]["a_log"] = np.ones(3, np.float32)
        with pytest.raises(ValueError, match="a_log"):
            params_from_numpy(tree, api.cfg, device="cpu")
        del tree[stack]["mixer"]["a_log"]
    else:
        del tree["dec_layers"]["cross_attn"]
    with pytest.raises(ValueError, match="want keys"):
        params_from_numpy(tree, api.cfg, device="cpu")


def test_whisper_cross_cache_is_padded_once_for_the_decode_kernel():
    """The cross cache holds ``ops.decode_cache_rows`` rows (Whisper-medium
    at batch 4: 1500 -> 1536, the planner's 8 ranges of 192), the rows past
    the frames zero, ``cross_len`` the frames; at those rows the plan
    divides the cache, so ``ops.decode_attention`` reads it with no pad
    copy.  At the full config's self cache (448 rows) no padding is
    needed either."""
    assert ops.decode_cache_rows(1500, 64, 1, 4 * 16, 2) == 1536
    for s in (448, 1536, 512):
        bkv, splits = ops._planned_split(s, 64 if s != 512 else 80, 1,
                                         4 * (16 if s != 512 else 32), 2)
        assert s % (bkv * splits) == 0, s
    for s, d, heads in ((13, 16, 8), (100, 64, 64), (1500, 64, 64),
                        (2048, 128, 16)):
        rows = ops.decode_cache_rows(s, d, 1, heads, 2)
        bkv, splits = ops._planned_split(rows, d, 1, heads, 2)
        assert rows >= s and rows % (bkv * splits) == 0
    api = registry.get_reduced("whisper-medium")
    params = api.init_params(5, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(98).standard_normal(
        (2, 13, api.cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    _, cache = api.prefill_fn(params, {"frames": frames})
    rows = ops.decode_cache_rows(13, api.cfg.head_dim, 1,
                                 2 * api.cfg.n_heads, 2)
    assert cache["cross_k"].shape[2] == rows
    assert cache["cross_len"].tolist() == [13, 13]
    assert bool((cache["cross_k"][:, :, 13:] == 0).all())
    assert bool((cache["self_k"][:, :, 1:] == 0).all())


@pytest.mark.parametrize("arch", IDS)
def test_each_decode_step_goes_through_ops_decode_attention(arch,
                                                            monkeypatch):
    """Zamba2's step calls the decode kernel's entry point once per shared
    block application (lengths ``pos + 1``), Whisper's twice per decoder
    layer (self with ``pos + 1``, cross with the frames), Mamba2's never;
    each on the cache as stored.  The step writes its cache in place."""
    api = registry.get_reduced(arch)
    cfg = api.cfg
    params = api.init_params(6, device="cpu")
    seen = []
    real = ops.decode_attention

    def spy(q, k, v, lengths=None, **kw):
        seen.append((tuple(k.shape), lengths.tolist()))
        return real(q, k, v, lengths, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    _, batch = _prefill_inputs(api, "bfloat16", 99, 2, 8)
    _, cache = api.prefill_fn(params, batch, max_len=12)
    before = [t.clone() for t in api.step_writes(cache, 1 if arch ==
                                                 "whisper-medium" else 8)]
    pos = 1 if arch == "whisper-medium" else 8
    api.decode_fn(params, cache, torch.ones((2, 1), dtype=torch.long), pos)
    after = api.step_writes(cache, pos)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    if arch == "mamba2-2.7b":
        assert seen == []
    elif arch == "zamba2-2.7b":
        # the KV cache holds the rows the kernel's plan walks in place
        kv = (2, transformer.cache_rows(cfg, 2, 12), cfg.n_kv_heads,
              cfg.head_dim)
        assert seen == [(kv, [9, 9])] * (cfg.n_layers // cfg.attn_every)
    else:
        self_kv = (2, cfg.dec_seq, cfg.n_heads, cfg.head_dim)
        cross_kv = (2, cache["cross_k"].shape[2], cfg.n_heads, cfg.head_dim)
        assert seen == [(self_kv, [2, 2]), (cross_kv, [8, 8])] * \
            cfg.dec_layers


@pytest.mark.parametrize("arch", IDS)
def test_step_writes_are_views_of_the_cache(arch):
    """What the graph step saves around its warm-up: views into the cache
    (a write to one lands in the cache), at the last position the model's
    step may take (Whisper's ``dec_seq - 1``, Zamba2's last KV row)."""
    api = registry.get_reduced(arch)
    params = api.init_params(7, device="cpu")
    _, batch = _prefill_inputs(api, "bfloat16", 100, 2, 8)
    _, cache = api.prefill_fn(params, batch, max_len=12)
    last = api.last_pos(cache)
    want = {"mamba2-2.7b": lambda: 0,
            "zamba2-2.7b": lambda: transformer.cache_rows(api.cfg, 2, 12) - 1,
            "whisper-medium": lambda: api.cfg.dec_seq - 1}[arch]()
    assert last == want
    written = api.step_writes(cache, last)
    assert written
    for t in written:
        t.fill_(7)
    if arch == "whisper-medium":
        assert bool((cache["self_k"][:, :, last] == 7).all())
        assert not bool((cache["cross_k"] == 7).any())
    elif arch == "zamba2-2.7b":
        assert bool((cache["attn"]["v"][:, :, last] == 7).all())
        assert not bool((cache["attn"]["v"][:, :, last - 1] == 7).any())
        assert bool((cache["mamba"]["h"] == 7).all())
    else:
        assert bool((cache["h"] == 7).all())
        assert bool((cache["conv"] == 7).all())
