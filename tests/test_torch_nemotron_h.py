"""Nemotron-H with routed experts (``models/nemotron_h.py``, the serving
path of ``nemotron-3-nano-30b-a3b``) against the plain reference
``bench/reference/nemotron_h.py`` (plain torch, float32, loaded by path:
it imports nothing of the port), on the CPU, at a small size that keeps
every kind of block (``NemotronHConfig.reduced``: ``MEM*EME*``, d 64, six
Mamba-2 heads of 16 so that d_inner is not expand x d, B and C in 2
groups, 8 relu^2 experts of 32, top 2, a shared expert of 48, attention
4 / 2 heads of 16 with no rotary embedding).  The weights are the port's
seeded ``init_params`` in float32, the Mamba-2 constants drawn as a
trained model has them and the routers' selection bias nonzero, the
same tensors for both.

Tolerances, relative to the largest reference logit (or state):

- ``FULL_TOL`` 2e-5: the full-sequence form in float32 computes the same
  sums in another order (the chunked SSD scan against the reference's
  step-by-step recurrence, the online softmax, the experts in slots
  against the reference's expert-by-expert loop); read 6.2e-7.
- ``CHAIN_TOL`` 1e-2: prefill, then decode steps through the port's own
  cache, which stores the KV rows and the conv window in bfloat16:
  entries rounded by up to 2**-9 of themselves; read 2.6e-3.
- ``DECODE_TOL`` 2e-5: decode steps from the reference's own float32
  state after the prompt, in a float32 cache: another order of sums, and
  K5's plain version's online softmax, over steps whose errors compound;
  read 6.3e-7.

The reference with its recurrent state rounded to bfloat16 between steps
(the control, read 3.8e-4) misses ``DECODE_TOL`` by more than ten
times.
"""
import ast
import importlib.util
import inspect
import pathlib
import textwrap
import types

import pytest
import torch

from repro_torch.launch import steps
from repro_torch.models import moe, nemotron_h, registry, ssm
from repro_torch.models.common import init_params, map_defs
from repro_torch.models.layers import rmsnorm
from repro_torch.models.transformer import cache_rows
from repro_torch.obs import counters, spans

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "nemotron-3-nano-30b-a3b"
FULL_TOL = 2e-5
CHAIN_TOL = 1e-2
DECODE_TOL = 2e-5
PROMPT, STEPS = 24, 8
HOST_READS = {"item", "cpu", "numpy", "tolist", "nonzero", "synchronize"}


def load_reference():
    spec = importlib.util.spec_from_file_location(
        "nemotron_h_reference", ROOT / "bench" / "reference" / "nemotron_h.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = load_reference()


def model_dict(cfg) -> dict:
    """The configuration under the published config.json's keys."""
    return {"hidden_size": cfg.d_model, "mamba_num_heads": cfg.ssm_n_heads,
            "mamba_head_dim": cfg.ssm_head_dim, "n_groups": cfg.ssm_groups,
            "ssm_state_size": cfg.ssm_state,
            "conv_kernel": cfg.ssm_conv_width,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "n_routed_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.top_k,
            "routed_scaling_factor": cfg.routed_scale,
            "layer_norm_epsilon": cfg.norm_eps,
            "hybrid_override_pattern": cfg.pattern}


def make_params(api, seed: int = 3):
    """The port's seeded weights in float32; the Mamba-2 constants drawn
    as a trained model has them, the routers' bias nonzero."""
    p = map_defs(lambda t: t.float(), api.init_params(seed, device="cpu"))
    gen = torch.Generator().manual_seed(seed + 100)
    for i, kind in enumerate(api.cfg.pattern):
        m = p["blocks"][str(i)]["mixer"]
        if kind == "M":
            m["a_log"].copy_(torch.log(1 + 15 * torch.rand(
                m["a_log"].shape, generator=gen)))
            lo, hi = torch.log(torch.tensor(1e-3)), \
                torch.log(torch.tensor(1e-1))
            dt = torch.exp(lo + (hi - lo) * torch.rand(m["dt_bias"].shape,
                                                       generator=gen))
            m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
            m["d_skip"].copy_(1 + 0.1 * torch.randn(m["d_skip"].shape,
                                                    generator=gen))
            m["conv_b"].copy_(0.1 * torch.randn(m["conv_b"].shape,
                                                generator=gen))
        elif kind == "E":
            m["router_bias"].copy_(0.5 * torch.randn(
                m["router_bias"].shape, generator=gen))
    return p


@pytest.fixture(scope="module")
def setup():
    api = registry.get_reduced(ARCH)
    params = make_params(api)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, api.cfg.vocab, (2, PROMPT + STEPS),
                           generator=gen)
    run = REF.forward(params, model_dict(api.cfg), tokens)
    run["logits"] = REF.full_logits(params, run["hidden"])
    return api, params, tokens, run


def _full_logits(api, params, tokens):
    x, *_ = nemotron_h._sequence(params, tokens, api.cfg)
    x = rmsnorm(x, params["norm_f"], api.cfg.norm_eps)
    return x.float() @ params["lm_head"].float()


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
    api = registry.get(ARCH)
    cfg = api.cfg
    assert ARCH in registry.SERVED_IDS and ARCH not in registry.ARCH_IDS
    assert api.module is nemotron_h and not api.meshed
    blocks = nemotron_h.kinds(cfg)
    assert [len(blocks[k]) for k in "ME*"] == [23, 23, 6]
    assert blocks["*"] == [5, 12, 19, 26, 33, 42]
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_groups, cfg.ssm_state, cfg.head_dim, cfg.d_ff,
            cfg.shared_expert_ff, cfg.n_experts, cfg.top_k,
            cfg.routed_scale, cfg.vocab) == \
        (52, 2688, 4096, 64, 8, 128, 128, 1856, 3712, 128, 6, 2.5, 131072)
    assert cfg.d_inner != cfg.ssm_expand * cfg.d_model
    defs = api.param_defs()
    experts = defs["blocks"]["1"]["mixer"]
    assert experts["w_up"].shape == (128, 2688, 1856)
    assert "w_gate" not in experts
    assert experts["shared"]["w_up"].shape == (2688, 3712)
    assert defs["blocks"]["0"]["mixer"]["in_proj"].shape == \
        (2688, 2 * 4096 + 2 * 8 * 128 + 64)
    assert defs["lm_head"].shape == (2688, 131072)


def test_the_full_sequence_logits_match_the_reference(setup):
    api, params, tokens, want = setup
    err = _rel(_full_logits(api, params, tokens), want["logits"])
    assert err < FULL_TOL, err


def test_prefill_then_decode_match_the_full_forward_pass(setup):
    """Through the port's own cache as it stores it: the prefill's last
    logits, then every decode step's, and every attention block's KV
    rows."""
    api, params, tokens, want = setup
    logits, cache = api.prefill_fn(params, {"tokens": tokens[:, :PROMPT]},
                                   max_len=PROMPT + STEPS)
    got = torch.cat([logits[:, None], _decode(api, params, cache, tokens)],
                    dim=1)
    err = _rel(got, want["logits"][:, PROMPT - 1:PROMPT + STEPS - 1])
    assert err < CHAIN_TOL, err
    for j in range(len(nemotron_h.kinds(api.cfg)["*"])):
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
    last = REF.forward(params, model_dict(api.cfg), tokens[:, :-1])
    assert _rel(cache["mamba"]["h"], torch.stack(last["h"])) < DECODE_TOL
    control = REF.forward(params, model_dict(api.cfg), tokens,
                          state_dtype=torch.bfloat16)
    c_logits = REF.full_logits(params, control["hidden"])
    c_err = _rel(c_logits[:, PROMPT:PROMPT + STEPS - 1], ref_logits)
    assert c_err > 10 * DECODE_TOL, c_err


def test_the_router_bias_moves_the_choice_and_not_the_weights():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(16, 12, generator=gen)
    router = torch.randn(12, 8, generator=gen)
    scores = torch.sigmoid(x @ router)
    zero = torch.zeros(8)
    w0, e0 = moe.route_sigmoid(x, router, zero, 2, 2.5)
    # renormalised, then times 2.5; the chosen are the top scores
    assert torch.allclose(w0.sum(-1), torch.full((16,), 2.5))
    assert torch.equal(e0.sort(-1).values,
                       torch.topk(scores, 2).indices.sort(-1).values)
    assert torch.allclose(w0, scores.gather(-1, e0)
                          / scores.gather(-1, e0).sum(-1, keepdim=True)
                          * 2.5)
    # a bias on expert 3 puts it in every token's choice; its weight is
    # still its score, renormalised, not the score plus the bias
    bias = zero.clone()
    bias[3] = 10.0
    w, e = moe.route_sigmoid(x, router, bias, 2, 2.5)
    assert (e == 3).any(-1).all()
    picked = scores.gather(-1, e)
    assert torch.allclose(w, picked / picked.sum(-1, keepdim=True) * 2.5)
    ref_w, ref_e, short = REF.route(x, router, bias, 2, 2.5)
    assert torch.equal(ref_e.sort(-1).values, e.sort(-1).values)
    assert torch.allclose(ref_w.sort(-1).values, w.sort(-1).values)
    assert not short.any()
    # the reference follows choices it is given, weighs them by its own
    # scores, and reports how far they lie below its own k-th
    given = torch.stack([e[:, 0], (e[:, 0] + 1) % 8], dim=-1)
    gw, ge, short = REF.route(x, router, bias, 2, 2.5, chosen=given)
    assert torch.equal(ge, given)
    picked = scores.gather(-1, given)
    assert torch.allclose(gw, picked / picked.sum(-1, keepdim=True) * 2.5)
    biased = scores + bias
    kth = torch.topk(biased, 2).values[:, -1]
    want = (kth - biased.gather(-1, given).min(-1).values).clamp_min(0)
    assert torch.allclose(short, want) and short.any()


def _one_layer(api, params):
    """The first expert block's weights and a random input."""
    i = api.cfg.pattern.index("E")
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(3, 5, api.cfg.d_model, generator=gen)
    return params["blocks"][str(i)]["mixer"], x


def test_relu2_experts_and_the_shared_expert_of_its_own_width(setup):
    api, params, _, _ = setup
    cfg = api.cfg
    mp, x = _one_layer(api, params)
    assert mp["shared"]["w_up"].shape == (cfg.d_model, cfg.shared_expert_ff)
    assert cfg.shared_expert_ff != cfg.n_shared_experts * cfg.d_ff
    s = REF.sizes(model_dict(cfg))
    got, _ = moe.dropless(x, mp, cfg, 15)
    assert _rel(got, REF.experts(x, mp, s)[0]) < 1e-6
    # by hand: each token's two experts, relu squared, weighted, plus the
    # shared expert's down(relu(up x)^2)
    xf = x.reshape(15, -1)
    w, e = moe.route_sigmoid(xf, mp["router"], mp["router_bias"], 2, 2.5)
    want = torch.stack([
        sum(w[t, j] * (torch.relu(xf[t] @ mp["w_up"][e[t, j]]) ** 2)
            @ mp["w_down"][e[t, j]] for j in range(2))
        + (torch.relu(xf[t] @ mp["shared"]["w_up"]) ** 2)
        @ mp["shared"]["w_down"] for t in range(15)])
    assert _rel(got.reshape(15, -1), want) < 1e-6


@pytest.mark.parametrize("capacity", [15, None])
def test_a_router_that_sends_every_token_to_one_expert_drops_nothing(
        setup, capacity):
    """The selection bias of expert 0 so large that every token chooses
    it: its load is every token, past the JAX package's capacity
    (tokens x k / E x 1.25, at least 8), which would drop pairs; the
    decode step's capacity (the token count) and the prefill's (the
    largest load, read back) keep them all, equal to the reference."""
    api, params, _, _ = setup
    cfg = api.cfg
    mp, x = _one_layer(api, params)
    mp = dict(mp, router_bias=mp["router_bias"].clone())
    mp["router_bias"][0] = 1e3
    _, e = moe.route_sigmoid(x.reshape(15, -1), mp["router"],
                             mp["router_bias"], cfg.top_k, cfg.routed_scale)
    assert (e == 0).any(-1).all()
    assert moe._capacity(15, cfg) < 15
    got, _ = moe.dropless(x, mp, cfg, capacity)
    want = REF.experts(x, mp, REF.sizes(model_dict(cfg)))[0]
    assert _rel(got, want) < 1e-6
    # a capacity that drops pairs is visibly wrong here
    dropped, _ = moe.dropless(x, mp, cfg, 8)
    assert _rel(dropped, want) > 1e-2


def test_the_cache_keeps_every_tokens_routes(setup):
    """Prefill keeps each prompt token's experts at every expert block,
    and a decode step row ``pos``'s, in the cache beside the K and V
    rows: in float32 the reference's own choices."""
    api, params, tokens, want = setup
    _, cache = api.prefill_fn(params, {"tokens": tokens[:, :PROMPT]},
                              max_len=PROMPT + STEPS)
    routes = cache["moe"]["routes"]
    n_e = api.cfg.pattern.count("E")
    assert routes.dtype == torch.int16
    assert routes.shape[:2] == (n_e, 2) and routes.shape[3] == api.cfg.top_k
    _decode(api, params, cache, tokens)
    got = routes[:, :, :PROMPT + STEPS - 1].long().sort(-1).values
    ref = torch.stack(want["routes"])[:, :, :PROMPT + STEPS - 1]
    assert torch.equal(got, ref.sort(-1).values)
    assert not routes[:, :, PROMPT + STEPS - 1:].any()


def test_the_decode_step_reads_nothing_back_to_the_host():
    """No function the decode step runs calls ``.item()``, ``.cpu()``,
    ``nonzero`` or the like, or takes ``int``/``float``/``bool`` of a
    value: the routing's capacity is the step's token count."""
    fns = (nemotron_h.decode_fn, nemotron_h._attend_decode,
           nemotron_h._qkv, nemotron_h.expert_mixer, moe.dropless,
           moe.relu2_experts, moe.route_sigmoid, moe._slots, ssm.ssd_decode)
    for fn in fns:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in HOST_READS, (fn.__name__, node.attr)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name):
                assert node.func.id not in ("int", "float", "bool"), \
                    (fn.__name__, node.func.id)


def test_an_expert_layer_records_its_span_tree_under_the_gate(
        setup, monkeypatch):
    api, params, _, _ = setup
    mp, x = _one_layer(api, params)
    spans.clear()
    try:
        moe.dropless(x, mp, api.cfg, 15)
        assert spans.snapshot().spans == () and spans.RECORDER.kept == []
        monkeypatch.setattr(spans, "GATE",
                            types.SimpleNamespace(_is_profiler_enabled=True))
        moe.dropless(x, mp, api.cfg, 15)
        moe.dropless(x, mp, api.cfg, 15)
        snap = spans.snapshot()
        names = ["moe.layer", "moe.route", "moe.experts", "moe.shared",
                 "moe.combine"]
        assert [s.name for s in snap.spans] == names * 2
        assert [s.parent for s in snap.spans] == [-1, 0, 0, 0, 0,
                                                  -1, 5, 5, 5, 5]
        assert [s.arg for s in snap.spans if s.parent < 0] == [15, 15]
        kept = spans.RECORDER.kept
        assert len(kept) == 2 and kept[0].shape == (15, api.cfg.top_k)
        for s in (snap.spans[0], snap.spans[5]):
            kids = [c for c in snap.spans if c.root == s.root
                    and c.parent >= 0]
            assert [c.start_ns for c in kids[1:]] == \
                [c.end_ns for c in kids[:-1]]
            assert s.start_ns <= kids[0].start_ns and \
                kids[-1].end_ns <= s.end_ns
    finally:
        spans.clear()


def test_an_eager_decode_step_counts_one_nemotron_moe_an_expert_block(setup):
    api, params, tokens, _ = setup
    _, cache = api.prefill_fn(params, {"tokens": tokens[:, :PROMPT]},
                              max_len=PROMPT + STEPS)
    before = dict(counters.COUNTS)
    api.decode_fn(params, cache, tokens[:, PROMPT:PROMPT + 1], PROMPT)
    diff = {k: v - before.get(k, 0) for k, v in counters.COUNTS.items()}
    assert diff["nemotron_moe"] == api.cfg.pattern.count("E") == 3
    assert diff["ssm_update"] == api.cfg.pattern.count("M") == 3


@pytest.mark.gpu
def test_the_decode_step_is_captured_with_every_kind_of_block():
    """On the card: the reduced model's decode step captured as a CUDA
    graph replays the eager step's logits and state, and a replay makes
    one ``nemotron_moe`` an expert block, one ``ssd_update_kernel`` a
    Mamba block and one K5 launch an attention block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph captures CUDA kernels")
    dev = torch.device("cuda")
    api = registry.get_reduced(ARCH)
    params = make_params(api)
    params = map_defs(lambda t: t.to(dev, torch.bfloat16)
                      if t.dtype == torch.float32 and t.dim() >= 2
                      and t.shape[-1] != api.cfg.n_experts else t.to(dev),
                      params)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, api.cfg.vocab, (2, PROMPT + STEPS),
                           generator=gen).to(dev)
    _, cache = api.prefill_fn(params, {"tokens": tokens[:, :PROMPT]},
                              max_len=PROMPT + STEPS)
    saved = map_defs(lambda t: t.clone(), cache)
    tok = tokens[:, PROMPT:PROMPT + 1]
    want, _ = api.decode_fn(params, cache, tok, PROMPT)
    want = want.clone()
    after = map_defs(lambda t: t.clone(), cache)
    for dst, src in zip(leaves_of(cache), leaves_of(saved)):
        dst.copy_(src)
    step = steps.graph_decode_step(api, params, cache, 2)
    got = step(tok, PROMPT)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(leaves_of(cache), leaves_of(after)):
        assert torch.equal(a, b)
    per = step.launches_per_replay
    assert per["nemotron_moe"] == 3
    assert per["ssd_update_kernel"] == per["ssm_update"] == 3
    assert per["flash_decode"] == 2


def leaves_of(tree):
    from repro_torch.models.common import leaves
    return leaves(tree)
