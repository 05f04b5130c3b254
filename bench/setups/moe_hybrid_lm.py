"""Greedy decoding of Nemotron-H with routed experts as published
(Mamba-2, routed-expert and attention blocks in one pattern) through the
program's serving step.

Set-up makes the weights on the device from the seed, in a few large
calls, in bfloat16 (the routers, their selection bias and the Mamba-2
blocks' per-head A, dt bias and D in float32), laid out as the program's
``models/nemotron_h.py`` takes them; makes the cache of ``batch``
sessions that have each read ``context`` tokens in place of a prefill:
every attention block's first ``context`` K and V rows, every Mamba
block's recurrent state and conv window, all drawn from the seed into the
layout ``cache_defs`` gives, with ``cache_rows``' padding; and captures
the decode step once as a CUDA graph (``launch/steps.py::
graph_decode_step`` over ``decode_fn``: the recurrent update on every
Mamba block, the routed experts with a capacity of the step's tokens on
every expert block, the hand-written decode attention on every attention
block).  The model is the configuration's, built as the program's
``NemotronHConfig``.

Traffic, the window and the check's sessions as ``setups/hybrid_lm.py``
makes them (its ``Cell``, whose stepping, window and release this cell
shares): generations of ``gen`` greedy steps from position ``context``,
each starting again with tokens and states drawn from the seed, at most
``dispatch_ahead`` steps in flight.  The traced sub-window replays
``trace_steps`` steps alone.  Its ``eager``, which the expert layers'
readers call (``harness/moe_trace.py``), then runs, once, a profiler
session of its own: ``FIT_REPLAYS`` replays, whose spans fit the clock,
and ``eager_steps`` more steps of the same generation through the eager
``decode_fn`` (no graph), whose expert layers record their host spans
(``moe.layer`` over ``moe.route``, ``moe.experts``, ``moe.shared``,
``moe.combine``) and keep their choices.

The check, once the window has closed: ``check_sessions`` sessions of
the last generation, teacher-forced through the plain reference
(``reference/nemotron_h.py``) from the same rows and states (made again
from the seed), the same weights and the served tokens, the reference
taking at every expert block the experts the timed path chose (the
routes the decode step kept in its cache).  The routing is discontinuous:
at a near-tie of the k-th and the next expert's biased scores a bfloat16
rounding flips a choice, and the flipped expert moves that token's
output by about 0.4 of the layer's own; were each side to choose for
itself, a flip would reach every later block's routing and, after a few
expert blocks, part the two by tens of per cent however correct the
program.  Following the timed path's choices, the reference parts from
it by its precision alone, and the choices themselves are held by how
far each lies below the reference's own.  Compared:

- ``logit_gap``: the widest gap by which a served token's logit lies
  below the reference's best (the head taken a few positions at a time);
- ``kv_rows_err``: the rows the steps wrote into each attention block's
  K and V, the widest error over the root mean square of the reference's
  rows;
- ``state_err``: the first Mamba block's state after the last step, head
  by head and session by session, the widest error over the largest
  magnitude of the reference's head (the first block precedes every
  expert block and reads the served tokens' embedding rows, the same on
  both sides: its error is the recurrence's own and its projections');
- ``state_coarse_share``: every Mamba block's state, held to float32, as
  in the hybrid cell;
- ``route_shortfall``: over every expert block and token, how far the
  lowest of the experts the timed path chose lies below the k-th largest
  of the reference's biased scores (0 where they are its own top-k);
- ``expert_out_err``: block by block, the program's expert block as the
  decode step runs it (``nemotron_h.expert_mixer``, ``batch`` tokens a
  call) on the reference's own input rounded to bfloat16, against the
  reference on the same input following the program's choices there: the
  widest error of a token's output, the norm of the difference over the
  reference's.  No error can come from an earlier block, so a dropped
  pair, a wrong weight or a coarse product shows at its own block.

With ``control``, each control (the reference in fp8, or with its state
through bfloat16) is run in the program's place, on its own choices,
against the reference that follows them: the same numbers under
``control.`` and ``control.bf16_state.``.
"""
from __future__ import annotations

import math
import time

from harness import inputs, spec
from reference import nemotron_h as ref

hybrid = spec.setup_module("hybrid_lm")

STATE_STD = hybrid.STATE_STD    # the seeded states' spread (``assumed``)
FIT_REPLAYS = 2                 # replays that fit the eager trace's clock
BIAS_STD = 0.05                 # e_score_correction_bias's (``assumed``)


def arch_config(model: dict):
    """The configuration as the program's ``NemotronHConfig``."""
    from repro_torch.models.common import NemotronHConfig
    s = ref.sizes(model)
    return NemotronHConfig(
        name=model["name"], family="nemotron_h",
        n_layers=model["num_hidden_layers"], pattern=s["pattern"],
        d_model=s["d"], n_heads=s["h"], n_kv_heads=s["hk"],
        head_dim=s["dh"], d_ff=model["moe_intermediate_size"],
        vocab=model["vocab_size"], rope_theta=float(model["rope_theta"]),
        n_experts=s["experts"], top_k=s["top_k"],
        n_shared_experts=model["n_shared_experts"],
        shared_expert_ff=model["moe_shared_expert_intermediate_size"]
        * model["n_shared_experts"],
        routed_scale=float(s["scale"]), ssm_state=s["n"],
        ssm_expand=model["expand"], ssm_head_dim=s["p"],
        ssm_n_heads=s["heads"], ssm_conv_width=s["width"],
        ssm_chunk=model["chunk_size"], ssm_groups=s["groups"],
        norm_eps=s["eps"])


def blocks_of(model: dict, kind: str) -> list:
    return [i for i, k in enumerate(model["hybrid_override_pattern"])
            if k == kind]


def weight_leaves(model: dict) -> list:
    """(path, shape, kind) of every bfloat16 weight, in the order they are
    drawn."""
    s = ref.sizes(model)
    d, di, f = s["d"], s["di"], model["moe_intermediate_size"]
    fs = model["moe_shared_expert_intermediate_size"] \
        * model["n_shared_experts"]
    e, hq, hkv = s["experts"], s["h"] * s["dh"], s["hk"] * s["dh"]
    proj = 2 * di + 2 * s["groups"] * s["n"] + s["heads"]
    out = [(("embed",), (model["vocab_size"], d), "table")]
    for i, kind in enumerate(s["pattern"]):
        b = ("blocks", str(i))
        out.append((b + ("norm",), (d,), "norm"))
        m = b + ("mixer",)
        if kind == "M":
            out += [(m + ("in_proj",), (d, proj), "matrix"),
                    (m + ("conv_w",), (s["width"], s["conv"]), "matrix"),
                    (m + ("conv_b",), (s["conv"],), "bias"),
                    (m + ("norm_w",), (di,), "norm"),
                    (m + ("out_proj",), (di, d), "matrix")]
        elif kind == "E":
            out += [(m + ("w_up",), (e, d, f), "matrix"),
                    (m + ("w_down",), (e, f, d), "matrix")]
            if fs:
                out += [(m + ("shared", "w_up"), (d, fs), "matrix"),
                        (m + ("shared", "w_down"), (fs, d), "matrix")]
        else:
            out += [(m + ("wq",), (d, hq), "matrix"),
                    (m + ("wk",), (d, hkv), "matrix"),
                    (m + ("wv",), (d, hkv), "matrix"),
                    (m + ("wo",), (hq, d), "matrix")]
    out += [(("norm_f",), (d,), "norm"),
            (("lm_head",), (d, model["vocab_size"]), "matrix")]
    return out


def _node(tree: dict, path: tuple) -> dict:
    for p in path:
        tree = tree.setdefault(p, {})
    return tree


def make_weights(torch, model: dict, device, seed: int) -> dict:
    """N(0, 1) draws, one flat bfloat16 tensor, then scaled: matrices by
    1/sqrt(fan_in) (the conv's fan-in is its width), biases by 0.02, norms
    1 + 0.02 N(0, 1), the embedding by 0.02.  Float32, each block its own
    draw: the routers N(0, 1/hidden_size) and their selection bias
    N(0, BIAS_STD^2); the Mamba-2 blocks' A from U(1, 16), dt
    log-uniform in [time_step_min, time_step_max] floored at
    time_step_floor (its inverse softplus the bias), D 1 + 0.02 N(0, 1)."""
    leaves = weight_leaves(model)
    shapes = [shape for _, shape, _ in leaves]
    total = sum(math.prod(s) for s in shapes)
    views = inputs.carve(inputs.normal(torch, total, torch.bfloat16, device,
                                       seed, "weights"), shapes)
    tree = {}
    for (path, shape, kind), t in zip(leaves, views):
        if kind == "matrix":
            t.mul_(shape[-2] ** -0.5)
        elif kind in ("bias", "table"):
            t.mul_(0.02)
        elif kind == "norm":
            t.mul_(0.02).add_(1.0)
        _node(tree, path[:-1])[path[-1]] = t
    s = ref.sizes(model)
    lo, hi = math.log(model["time_step_min"]), math.log(model["time_step_max"])
    for i in blocks_of(model, "M"):
        gen = inputs.generator(torch, device, seed, "mixer constants", i)

        def draw(fn):
            return fn((s["heads"],), generator=gen, device=device,
                      dtype=torch.float32)

        mixer = tree["blocks"][str(i)]["mixer"]
        mixer["a_log"] = torch.log(1 + 15 * draw(torch.rand))
        dt = torch.exp(lo + (hi - lo) * draw(torch.rand)).clamp_min(
            model["time_step_floor"])
        mixer["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
        mixer["d_skip"] = 1 + 0.02 * draw(torch.randn)
    for i in blocks_of(model, "E"):
        gen = inputs.generator(torch, device, seed, "router", i)
        mixer = tree["blocks"][str(i)]["mixer"]
        mixer["router"] = torch.randn(
            (s["d"], s["experts"]), generator=gen, device=device,
            dtype=torch.float32) * s["d"] ** -0.5
        mixer["router_bias"] = BIAS_STD * torch.randn(
            (s["experts"],), generator=gen, device=device,
            dtype=torch.float32)
    return tree


def kv_rows_from_seed(torch, model: dict, batch: int, context: int, device,
                      seed: int, j: int, kind: str):
    """The ``j``-th attention block's first ``context`` rows of ``kind``
    ("k" or "v") of every session, (batch, context, H_kv, D) bfloat16."""
    s = ref.sizes(model)
    shape = (batch, context, s["hk"], s["dh"])
    return inputs.normal(torch, math.prod(shape), torch.bfloat16, device,
                         seed, "cache", kind, j).view(shape)


def state_from_seed(torch, model: dict, batch: int, device, seed: int,
                    j: int, out=None):
    """The ``j``-th Mamba block's recurrent state (batch, H, P, N)
    float32, N(0, STATE_STD^2), and conv window (batch, W-1, C) bfloat16,
    N(0, 1): into ``out`` (the program's two tensors of that block) when
    given."""
    s = ref.sizes(model)
    h_shape = (batch, s["heads"], s["p"], s["n"])
    c_shape = (batch, s["width"] - 1, s["conv"])
    h = out[0] if out is not None else torch.empty(
        h_shape, dtype=torch.float32, device=device)
    conv = out[1] if out is not None else torch.empty(
        c_shape, dtype=torch.bfloat16, device=device)
    h.normal_(0.0, STATE_STD, generator=inputs.generator(
        torch, device, seed, "state", j))
    conv.normal_(generator=inputs.generator(torch, device, seed,
                                            "conv window", j))
    return h, conv


class Cell(hybrid.Cell):
    # ------------------------------------------------------------ set-up
    def build(self) -> None:
        torch, dev, m = self.torch, self.device, self.model
        from repro_torch.launch import steps
        from repro_torch.models import nemotron_h
        from repro_torch.models.common import init_params
        from repro_torch.models.registry import ModelApi
        from repro_torch.models.transformer import cache_rows
        self.arch = arch = arch_config(m)
        api = ModelApi(cfg=arch, module=nemotron_h)
        b, ctx, g = self.batch, self.context, self.gen
        t0 = time.perf_counter()
        self.weights = make_weights(torch, m, dev, self.seed)
        self._sync()
        self.spans["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = cache_rows(arch, b, ctx + g)
        self.cache = init_params(api.cache_defs(b, rows), device=dev)
        for j in range(len(blocks_of(m, "*"))):
            for kind in ("k", "v"):
                self.cache["attn"][kind][j, :, :ctx].copy_(
                    kv_rows_from_seed(torch, m, b, ctx, dev, self.seed, j,
                                      kind))
        self._seed_states()
        self.info["cache_rows"] = rows
        gen_dev = inputs.generator(torch, dev, self.seed, "first tokens")
        self.firsts = torch.randint(m["vocab_size"],
                                    (self.traffic["first_tokens"], b, 1),
                                    generator=gen_dev, device=dev)
        self.served = torch.zeros((g, b), dtype=torch.int64, device=dev)
        self._sync()
        self.spans["state_seed_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.decode = steps.make_decode_step(api)
        if dev.type == "cuda":
            step = steps.graph_decode_step(api, self.weights, self.cache, b)
            self.step = step
            self.info["launches_per_replay"] = dict(step.launches_per_replay)
        else:
            self.step = self._eager
        self.spans["capture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.n_gen, self.j = 0, 0
        self.tok = self.firsts[0]
        self.events = [self._event() for _ in range(self.traffic["events"])]
        for _ in range(self.traffic["warm_steps"]):
            self._one()
        graphed, self.step = self.step, self._eager
        self._one()
        self.step = graphed
        self.n_gen, self.j = 0, 0
        self.tok = self.firsts[0]
        self._seed_states()
        self._sync()
        self.spans["warm_s"] = time.perf_counter() - t0

    def _eager(self, tokens, pos):
        """One step through the eager ``decode_fn`` (no graph): its
        logits.  Held as the step only while it runs, so that the cell
        and its graph are freed with their last reference."""
        return self.decode(self.weights, self.cache, tokens, pos)[0]

    def _seed_states(self) -> None:
        """Every Mamba block's state and conv window drawn again from the
        seed, in place: fresh until the next step."""
        mamba = self.cache["mamba"]
        for j in range(len(blocks_of(self.model, "M"))):
            state_from_seed(self.torch, self.model, self.batch, self.device,
                            self.seed, j,
                            out=(mamba["h"][j], mamba["conv"][j]))
        self.fresh = True

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        """The hybrid cell's window; a generation with fewer than the
        traced, the fitting and the eager steps left is then finished, so
        that they lie inside one generation."""
        traffic = self.traffic
        self.traffic = dict(traffic, trace_steps=traffic["trace_steps"]
                            + FIT_REPLAYS + traffic["eager_steps"])
        try:
            return super().window(seconds)
        finally:
            self.traffic = traffic

    def traced(self) -> dict:
        """``trace_steps`` replays; ``eager`` runs, when a reader first
        calls it, the eager steps' own traced interval
        (:meth:`_eager_trace`) and gives (its device trace, its eager
        steps' host interval)."""
        out = self._drive(None, self.traffic["trace_steps"])
        done = []

        def eager():
            if not done:
                done.append(self._eager_trace())
            return done[0]
        out["eager"] = eager
        return out

    def _eager_trace(self):
        """After the traced sub-window, under a profiler session of its
        own: ``FIT_REPLAYS`` replays (their ``decode.replay`` spans hold
        their ``cudaGraphLaunch``, which fits the spans' clock to the
        trace's), then ``eager_steps`` steps of the same generation
        through the eager ``decode_fn``, whose expert layers record their
        spans and keep their choices (the program's recorder cleared
        first, so that it holds these alone).  Returns (the device trace,
        the eager steps' host interval on ``time.perf_counter_ns``, from
        before the first to after the device has finished the last)."""
        from harness import trace as trace_mod
        from repro_torch.obs import spans

        def work():
            for _ in range(FIT_REPLAYS):
                self._one()
            graphed, self.step = self.step, self._eager
            try:
                self._sync()
                t0 = time.perf_counter_ns()
                for _ in range(self.traffic["eager_steps"]):
                    self._one()
                self._sync()
                return t0, time.perf_counter_ns()
            finally:
                self.step = graphed
        spans.clear()
        return trace_mod.record(self.torch, self.device, work)

    def release(self) -> None:
        """The hybrid cell's, and the routes the last generation's steps
        kept for the sampled sessions, one (sessions, gen, k) tensor an
        expert block."""
        routes = self.cache["moe"]["routes"]
        super().release()
        idx = self.torch.tensor(self.sessions, device=self.device)
        c, g = self.context, self.gen
        self.got_routes = list(routes[:, idx, c:c + g].long())

    # ------------------------------------------------------------ check
    def check(self, control: bool = False) -> list:
        """The numbers of the module's docstring; with ``control``, each
        control's too: the reference run in fp8 or with a bfloat16 state,
        on its own choices, in the program's place, against the reference
        that follows those choices."""
        torch, m, dev = self.torch, self.model, self.device
        idx = torch.tensor(self.sessions, device=dev)
        cell = self

        class Init:
            """The sampled sessions' rows and states, made again."""

            def kv(self, j):
                return tuple(kv_rows_from_seed(
                    torch, m, cell.batch, cell.context, dev, cell.seed, j,
                    kind)[idx] for kind in ("k", "v"))

            def state(self, j):
                h, conv = state_from_seed(torch, m, cell.batch, dev,
                                          cell.seed, j)
                return h[idx], conv[idx]

        served = self.got_tokens
        tokens = torch.cat([self.first[:, None], served[:, :-1]], dim=1)
        probe = Probe(self, self._program_experts)
        want = ref.forward(self.weights, m, tokens, self.context, Init(),
                           routes=self.got_routes, hook=probe)
        best, at_served = self._head(want["hidden"], served)
        out = self._numbers("", best - at_served, self._program_rows(),
                            want["k"] + want["v"], self.got_h[0].float(),
                            want["h"][0], list(self.got_h),
                            want["shortfall"], probe.worst)
        if not control:
            return out
        s = ref.sizes(m)
        for tag, kw in (("control", {"quant": "fp8"}),
                        ("control.bf16_state",
                         {"state_dtype": torch.bfloat16})):
            c = ref.forward(self.weights, m, tokens, self.context, Init(),
                            **kw)
            picks = torch.cat([logits.argmax(dim=-1) for _, logits in
                               ref.logits(self.weights, c["hidden"],
                                          kw.get("quant"))], dim=1)

            def experts(ub, mp, kw=kw):
                y, chosen, _ = ref.experts(ub.float(), mp, s,
                                           kw.get("quant"))
                return y, chosen
            probe = Probe(self, experts)
            follow = ref.forward(self.weights, m, tokens, self.context,
                                 Init(), routes=c["routes"], hook=probe)
            best, at_pick = self._head(follow["hidden"], picks)
            out += self._numbers(f"{tag}.", best - at_pick, c["k"] + c["v"],
                                 follow["k"] + follow["v"], c["h"][0],
                                 follow["h"][0], c["h"], follow["shortfall"],
                                 probe.worst)
        return out

    def _program_experts(self, ub, mp):
        """The program's expert block (``nemotron_h.expert_mixer``, as the
        decode step runs it) on ``ub`` (n, G, d) bfloat16, ``batch``
        tokens a call: (its output (n, G, d), its experts (n, G, k))."""
        from repro_torch.models import nemotron_h
        cat = self.torch.cat
        n, g, d = ub.shape
        flat, ys, es = ub.reshape(n * g, d), [], []
        for lo in range(0, n * g, self.batch):
            y, e = nemotron_h.expert_mixer(flat[lo:lo + self.batch, None],
                                           mp, self.arch)
            ys.append(y[:, 0])
            es.append(e[:, 0])
        return cat(ys).reshape(n, g, d), cat(es).reshape(n, g, -1)

    def _head(self, hidden, index):
        """The reference's head over ``hidden`` (n, G, d), a few positions
        at a time: (each position's best logit, its logit at ``index``
        (n, G)), both (n, G)."""
        best, picked = [], []
        for at, logits in ref.logits(self.weights, hidden):
            best.append(logits.max(dim=-1).values)
            picked.append(logits.gather(-1, index[:, at, None])[..., 0])
        return self.torch.cat(best, dim=1), self.torch.cat(picked, dim=1)

    def _numbers(self, tag, gaps, have_rows, rows, have_h, want_h, all_h,
                 shortfall, expert_err) -> list:
        torch, limits = self.torch, self.model["limits"]
        n, heads = gaps.numel(), want_h[..., 0, 0].numel()
        pairs = sum(t.numel() for t in shortfall)
        return [{"name": f"{tag}logit_gap", "value": gaps.max().item(),
                 "limit": limits["logit_gap"], "compared": n},
                {"name": f"{tag}kv_rows_err",
                 "value": hybrid._rows_err(have_rows, rows),
                 "limit": limits["kv_rows_err"], "compared": n},
                {"name": f"{tag}state_err",
                 "value": hybrid._state_err(have_h, want_h),
                 "limit": limits["state_err"], "compared": heads},
                {"name": f"{tag}state_coarse_share",
                 "value": hybrid._coarse_share(torch, all_h),
                 "limit": limits["state_coarse_share"],
                 "compared": self.got_h.numel()},
                {"name": f"{tag}route_shortfall",
                 "value": max(t.max().item() for t in shortfall),
                 "limit": limits["route_shortfall"], "compared": pairs},
                {"name": f"{tag}expert_out_err", "value": expert_err,
                 "limit": limits["expert_out_err"], "compared": pairs}]

    def _program_rows(self) -> list:
        blocks = len(blocks_of(self.model, "*"))
        return [self.got_kv[kind][j].float() for kind in ("k", "v")
                for j in range(blocks)]


class Probe:
    """The expert blocks, block by block: at each, the block under test
    (the program's, or a control's) and the reference on the same input,
    the reference's own input rounded to bfloat16 as the program's
    activations are, the reference following the choices of the block
    under test.  ``worst``: the widest error of a token's output, the
    norm of the difference over the reference's, over every block."""

    def __init__(self, cell, block):
        self.torch, self.block, self.worst = cell.torch, block, 0.0
        self.sizes = ref.sizes(cell.model)

    def __call__(self, j, u, mp):
        ub = u.to(self.torch.bfloat16)
        have, chosen = self.block(ub, mp)
        want, _, _ = ref.experts(ub.float(), mp, self.sizes, chosen=chosen)
        err = (have.float() - want).norm(dim=-1) / want.norm(dim=-1)
        self.worst = max(self.worst, err.max().item())
