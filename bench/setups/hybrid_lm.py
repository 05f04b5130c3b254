"""Greedy decoding of Zamba2 as published (Mamba-2 layers beside shared
attention blocks) through the program's serving step.

Set-up makes the weights on the device from the seed, in a few large
calls, in bfloat16 (the mixers' per-head A, dt bias and D in float32),
laid out as the program's ``models/zamba2.py`` takes them; makes the
cache of ``batch`` sessions that have each read ``context`` tokens in
place of a prefill: every application's first ``context`` K and V rows,
every layer's recurrent state and conv window, all drawn from the seed
into the layout ``cache_defs`` gives, with ``cache_rows``' padding; and
captures the decode step once as a CUDA graph
(``launch/steps.py::graph_decode_step`` over ``decode_fn``: the recurrent
update on every layer, the hand-written decode attention on every
application).  The model is the configuration's, built as the program's
``Zamba2Config``.

Traffic: generations of ``gen`` greedy steps from position ``context``;
each starts again at ``context`` with tokens drawn from the seed and the
states drawn again (the K and V rows of the context are never written).
Inside the window the draw is the first step's (every layer's state and
conv window, 9.7 GB written once a generation); the first generation's
states are drawn at set-up.  Steps are dispatched ahead (at most
``dispatch_ahead`` in flight) and their tokens stay on the device; a
CUDA event is recorded after each step.  After the window, outside it,
a generation with fewer than ``trace_steps`` steps left is finished and
the next one's states drawn, so that the traced steps lie inside one
generation and draw nothing; then the generation under way is finished.

The check, once the window has closed: ``check_sessions`` sessions drawn
from the seed, of the last generation, teacher-forced through the plain
reference (``reference/zamba2.py``) from the same rows and states (made
again from the seed), the same weights and the served tokens.  Compared:
the widest gap by which a served token's logit lies below the reference's
best (``logit_gap``); the rows the steps wrote into every application's
cache against the reference's keys and values (``kv_rows_err``: the
widest error over the root mean square of the reference's rows); and
the first layer's recurrent state after the last step against the
reference's (``state_err``: head by head and session by session, the
widest error over the largest magnitude of the reference's head).  The
first layer reads the served tokens' embedding rows, the same on both
sides, so its state's error is the recurrence's own and its
projections'; every deeper layer's carries the drift of the bfloat16
activations through the layers above it, which at the published depth
outweighs a state kept in bfloat16.  Head by head, because the state is
heavy-tailed (a head whose dt is large holds entries 10 to 90 times the
state's root mean square), and a head whose decay is slow loses it to a
bfloat16 state: its entries change by less than their rounding.  And
every layer's state, held to float32 (``state_coarse_share``: the share
of its entries whose float32 mantissa ends in 8 zero bits, about 1/256
for a state kept in float32 and all of them for one kept in 15 or fewer
mantissa bits, bfloat16's 7 or float16's 10): over 256 steps a bfloat16
state's error stays near the bfloat16 activations' own, except on the
few heads whose decay is slowest.
"""
from __future__ import annotations

import math
import random
import time

from harness import inputs
from reference import zamba2 as ref

STATE_STD = 0.05        # the seeded states' spread (``assumed``)


def arch_config(model: dict):
    """The configuration as the program's ``Zamba2Config``; the attention
    head 2 hidden_size / heads wide and the Mamba-2 heads expand x
    hidden_size / mamba_headdim, as the published configuration derives
    them."""
    from repro_torch.models.common import Zamba2Config
    s = ref.sizes(model)
    return Zamba2Config(
        name=model["name"], family="zamba2",
        n_layers=model["num_hidden_layers"], d_model=s["d"],
        n_heads=s["h"], n_kv_heads=s["hk"], head_dim=s["dh"], d_ff=s["ff"],
        vocab=model["vocab_size"], rope_theta=float(model["rope_theta"]),
        ssm_state=s["n"], ssm_expand=model["mamba_expand"],
        ssm_head_dim=s["p"], ssm_conv_width=s["width"],
        ssm_chunk=model["chunk_size"], ssm_groups=s["groups"],
        hybrid_layer_ids=tuple(hybrid_ids(model)),
        num_mem_blocks=model["num_mem_blocks"],
        adapter_rank=model["adapter_rank"], norm_eps=s["eps"])


def hybrid_ids(model: dict) -> list:
    return [i for i in model["hybrid_layer_ids"]
            if i < model["num_hidden_layers"]]


def weight_leaves(model: dict) -> list:
    """(path, shape, kind) of every bfloat16 weight, in the order they are
    drawn."""
    s = ref.sizes(model)
    d, di, ff, r = s["d"], s["di"], s["ff"], model["adapter_rank"]
    n, nb, na = model["num_hidden_layers"], s["blocks"], \
        len(hybrid_ids(model))
    hq, hkv = s["h"] * s["dh"], s["hk"] * s["dh"]
    proj = 2 * di + 2 * s["groups"] * s["n"] + s["heads"]
    return [
        (("embed",), (model["vocab_size"], d), "table"),
        (("mamba", "ln"), (n, d), "norm"),
        (("mamba", "mixer", "in_proj"), (n, d, proj), "matrix"),
        (("mamba", "mixer", "conv_w"), (n, s["width"], s["conv"]), "matrix"),
        (("mamba", "mixer", "conv_b"), (n, s["conv"]), "bias"),
        (("mamba", "mixer", "norm_w"), (n, di), "norm"),
        (("mamba", "mixer", "out_proj"), (n, di, d), "matrix"),
        (("blocks", "ln_attn"), (nb, 2 * d), "norm"),
        (("blocks", "wq"), (nb, 2 * d, hq), "matrix"),
        (("blocks", "wk"), (nb, 2 * d, hkv), "matrix"),
        (("blocks", "wv"), (nb, 2 * d, hkv), "matrix"),
        (("blocks", "wo"), (nb, hq, d), "matrix"),
        (("blocks", "ln_mlp"), (nb, d), "norm"),
        (("blocks", "w_gate_up"), (nb, d, 2 * ff), "matrix"),
        (("blocks", "w_down"), (nb, ff, d), "matrix"),
        (("apps", "adapter_in"), (na, d, r), "matrix"),
        (("apps", "adapter_out"), (na, r, 2 * ff), "matrix"),
        (("apps", "linear"), (na, d, d), "matrix"),
        (("ln_f",), (d,), "norm"),
    ]


def _put(tree: dict, path: tuple, t) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = t


def make_weights(torch, model: dict, device, seed: int) -> dict:
    """N(0, 1) draws, one flat bfloat16 tensor, then scaled: matrices by
    1/sqrt(fan_in) (the conv's fan-in is its width), biases by 0.02, norms
    1 + 0.02 N(0, 1), the embedding by 0.02 (tied, it is the head too:
    logits of about unit spread).  The mixers' float32
    constants: A from U(1, 16), dt log-uniform in [time_step_min,
    time_step_max] floored at time_step_floor (its inverse softplus the
    bias), D 1 + 0.02 N(0, 1)."""
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
        _put(tree, path, t)
    n, heads = model["num_hidden_layers"], ref.sizes(model)["heads"]
    gen = inputs.generator(torch, device, seed, "mixer constants")

    def draw(fn):
        return fn((n, heads), generator=gen, device=device,
                  dtype=torch.float32)

    mixer = tree["mamba"]["mixer"]
    mixer["a_log"] = torch.log(1 + 15 * draw(torch.rand))
    lo, hi = math.log(model["time_step_min"]), math.log(model["time_step_max"])
    dt = torch.exp(lo + (hi - lo) * draw(torch.rand)).clamp_min(
        model["time_step_floor"])
    mixer["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    mixer["d_skip"] = 1 + 0.02 * draw(torch.randn)
    return tree


def kv_rows_from_seed(torch, model: dict, batch: int, context: int, device,
                      seed: int, app: int, kind: str):
    """Application ``app``'s first ``context`` rows of ``kind`` ("k" or
    "v") of every session, (batch, context, H_kv, D) bfloat16."""
    s = ref.sizes(model)
    shape = (batch, context, s["hk"], s["dh"])
    return inputs.normal(torch, math.prod(shape), torch.bfloat16, device,
                         seed, "cache", kind, app).view(shape)


def state_from_seed(torch, model: dict, batch: int, device, seed: int,
                    layer: int, out=None):
    """Layer ``layer``'s recurrent state (batch, H, P, N) float32,
    N(0, STATE_STD^2), and conv window (batch, W-1, C) bfloat16, N(0, 1):
    into ``out`` (the program's two tensors of that layer) when given."""
    s = ref.sizes(model)
    h_shape = (batch, s["heads"], s["p"], s["n"])
    c_shape = (batch, s["width"] - 1, s["conv"])
    h = out[0] if out is not None else torch.empty(
        h_shape, dtype=torch.float32, device=device)
    conv = out[1] if out is not None else torch.empty(
        c_shape, dtype=torch.bfloat16, device=device)
    h.normal_(0.0, STATE_STD, generator=inputs.generator(
        torch, device, seed, "state", layer))
    conv.normal_(generator=inputs.generator(torch, device, seed,
                                            "conv window", layer))
    return h, conv


class Cell:
    def __init__(self, torch, device, cfg: dict, traffic: dict, seed: int):
        self.torch, self.device = torch, device
        self.model, self.traffic, self.seed = cfg, traffic, seed
        self.batch, self.context = traffic["batch"], traffic["context"]
        self.gen = traffic["gen"]
        self.info = {"model": cfg, "batch": self.batch,
                     "context": self.context, "gen": self.gen}
        self.spans = {}

    # ------------------------------------------------------------ set-up
    def build(self) -> None:
        torch, dev, m = self.torch, self.device, self.model
        from repro_torch.launch import steps
        from repro_torch.models import zamba2
        from repro_torch.models.common import init_params
        from repro_torch.models.registry import ModelApi
        from repro_torch.models.transformer import cache_rows
        arch = arch_config(m)
        api = ModelApi(cfg=arch, module=zamba2)
        b, ctx, g = self.batch, self.context, self.gen
        t0 = time.perf_counter()
        self.weights = make_weights(torch, m, dev, self.seed)
        self._sync()
        self.spans["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = cache_rows(arch, b, ctx + g)
        self.cache = init_params(api.cache_defs(b, rows), device=dev)
        for app in range(len(hybrid_ids(m))):
            for kind in ("k", "v"):
                self.cache["attn"][kind][app, :, :ctx].copy_(
                    kv_rows_from_seed(torch, m, b, ctx, dev, self.seed, app,
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
        if dev.type == "cuda":
            step = steps.graph_decode_step(api, self.weights, self.cache, b)
            self.step = step
            self.info["launches_per_replay"] = dict(step.launches_per_replay)
        else:
            fn = steps.make_decode_step(api)

            def step(tokens, pos):
                return fn(self.weights, self.cache, tokens, pos)[0]
            self.step = step
        self.spans["capture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.n_gen, self.j = 0, 0
        self.tok = self.firsts[0]
        self.events = [self._event() for _ in range(self.traffic["events"])]
        for _ in range(self.traffic["warm_steps"]):
            self._one()
        self.n_gen, self.j = 0, 0
        self.tok = self.firsts[0]
        self._seed_states()
        self._sync()
        self.spans["warm_s"] = time.perf_counter() - t0

    def _seed_states(self) -> None:
        """Every layer's state and conv window drawn again from the seed,
        in place: fresh until the next step."""
        mamba = self.cache["mamba"]
        for layer in range(self.model["num_hidden_layers"]):
            state_from_seed(self.torch, self.model, self.batch, self.device,
                            self.seed, layer,
                            out=(mamba["h"][layer], mamba["conv"][layer]))
        self.fresh = True

    def _event(self):
        if self.device.type == "cuda":
            return self.torch.cuda.Event(enable_timing=True)
        return None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _one(self) -> int:
        """One step of the generation under way (a new generation's
        states drawn again first, unless they are fresh); returns the
        length its attention read."""
        if self.j == 0 and not self.fresh:
            self._seed_states()
        self.fresh = False
        pos = self.context + self.j
        logits = self.step(self.tok, pos)
        self.tok = logits.argmax(dim=-1, keepdim=True)
        self.served[self.j].copy_(self.tok[:, 0])
        self.j += 1
        if self.j == self.gen:
            self.n_gen += 1
            self.j = 0
            self.tok = self.firsts[self.n_gen % len(self.firsts)]
        return pos + 1

    def _drive(self, seconds: float | None, count: int | None) -> dict:
        ahead, events = self.traffic["dispatch_ahead"], self.events
        cuda = self.device.type == "cuda"
        clock = time.perf_counter
        self._sync()
        start = self._event()
        t0 = clock()
        if cuda:
            start.record()
        done, lengths = 0, []
        while True:
            if count is None:
                if clock() - t0 >= seconds:
                    break
            elif done >= count:
                break
            lengths.append(self._one())
            if cuda:
                if done == len(events):
                    events.append(self._event())
                events[done].record()
                if done >= ahead:
                    events[done - ahead].synchronize()
            done += 1
        self._sync()
        elapsed = clock() - t0
        gaps = []
        if cuda and done:
            gaps = [start.elapsed_time(events[0])] + [
                events[i - 1].elapsed_time(events[i]) for i in range(1, done)]
        return {"elapsed_s": elapsed, "steps": done, "lengths": lengths,
                "gaps_ms": gaps}

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        from harness.yardstick import p95
        w = self._drive(seconds, None)
        w["decode_tokens_per_s"] = self.batch * w["steps"] / w["elapsed_s"]
        if w["gaps_ms"]:
            w["token_gap_ms_p95"] = p95(w["gaps_ms"])
        self.attempted = self.batch * w["steps"]
        if self.j == 0 or self.j + self.traffic["trace_steps"] > self.gen:
            while self.j:
                self._one()
            self._seed_states()
        return w

    def traced(self) -> dict:
        return self._drive(None, self.traffic["trace_steps"])

    def finish(self) -> None:
        """Finish the generation under way (outside the window), so that
        the last generation is whole: a whole one where the states of
        the next were drawn already."""
        while self.j or self.fresh:
            self._one()
        self._sync()
        self.last_gen = self.n_gen - 1

    def release(self) -> None:
        """Keep the last generation's tokens, the rows it wrote and the
        states it left for the sampled sessions; free the graph and the
        cache."""
        torch, b = self.torch, self.batch
        rng = random.Random(inputs.derive(self.seed, "check sessions"))
        self.sessions = sorted(rng.sample(range(b), min(
            self.traffic["check_sessions"], b)))
        idx = torch.tensor(self.sessions, device=self.device)
        c, g = self.context, self.gen
        self.got_kv = {kind: self.cache["attn"][kind][:, idx, c:c + g]
                       .clone() for kind in ("k", "v")}
        self.got_h = self.cache["mamba"]["h"][:, idx].clone()
        self.got_tokens = self.served[:, idx].t().clone()
        self.first = self.firsts[self.last_gen % len(self.firsts)][idx, 0]
        self.step = self.cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def check(self, control: bool = False) -> list:
        torch, m, dev = self.torch, self.model, self.device
        idx = torch.tensor(self.sessions, device=dev)
        cell = self

        class Init:
            """The sampled sessions' rows and states, made again."""

            def kv(self, app):
                return tuple(kv_rows_from_seed(
                    torch, m, cell.batch, cell.context, dev, cell.seed, app,
                    kind)[idx] for kind in ("k", "v"))

            def state(self, layer):
                h, conv = state_from_seed(torch, m, cell.batch, dev,
                                          cell.seed, layer)
                return h[idx], conv[idx]

        served = self.got_tokens
        tokens = torch.cat([self.first[:, None], served[:, :-1]], dim=1)
        want = ref.forward(self.weights, m, tokens, self.context, Init())
        logits = want["logits"]
        best = logits.max(dim=-1).values
        gap = (best - logits.gather(-1, served[..., None])[..., 0]).max()
        rows = want["k"] + want["v"]
        limits, n = m["limits"], served.numel()
        out = [{"name": "logit_gap", "value": gap.item(),
                "limit": limits["logit_gap"], "compared": n},
               {"name": "kv_rows_err",
                "value": _rows_err(self._program_rows(), rows),
                "limit": limits["kv_rows_err"], "compared": n},
               {"name": "state_err",
                "value": _state_err(self.got_h[0].float(), want["h"][0]),
                "limit": limits["state_err"],
                "compared": want["h"][0][..., 0, 0].numel()},
               {"name": "state_coarse_share",
                "value": _coarse_share(torch, list(self.got_h)),
                "limit": limits["state_coarse_share"],
                "compared": self.got_h.numel()}]
        if control:
            for tag, kw in (("control", {"quant": "fp8"}),
                            ("control.bf16_state",
                             {"state_dtype": torch.bfloat16})):
                c = ref.forward(self.weights, m, tokens, self.context,
                                Init(), **kw)
                pick = c["logits"].argmax(dim=-1, keepdim=True)
                c_gap = (best - logits.gather(-1, pick)[..., 0]).max()
                out += [{"name": f"{tag}.logit_gap", "value": c_gap.item(),
                         "limit": limits["logit_gap"], "compared": n},
                        {"name": f"{tag}.kv_rows_err",
                         "value": _rows_err(c["k"] + c["v"], rows),
                         "limit": limits["kv_rows_err"], "compared": n},
                        {"name": f"{tag}.state_err",
                         "value": _state_err(c["h"][0], want["h"][0]),
                         "limit": limits["state_err"],
                         "compared": want["h"][0][..., 0, 0].numel()},
                        {"name": f"{tag}.state_coarse_share",
                         "value": _coarse_share(torch, c["h"]),
                         "limit": limits["state_coarse_share"],
                         "compared": self.got_h.numel()}]
        return out

    def _program_rows(self) -> list:
        apps = len(hybrid_ids(self.model))
        return [self.got_kv[kind][app].float() for kind in ("k", "v")
                for app in range(apps)]


def _state_err(have, want) -> float:
    """States (sessions, heads, P, N): over every session's every head,
    the widest error of ``have``'s entries over the largest magnitude of
    ``want``'s."""
    dims = (-2, -1)
    return ((have - want).abs().amax(dim=dims)
            / want.abs().amax(dim=dims)).max().item()


def _coarse_share(torch, states: list) -> float:
    """The share of the float32 entries of ``states`` whose mantissa's
    low 8 bits are all zero."""
    coarse = sum(((h.float().contiguous().view(torch.int32) & 0xFF) == 0)
                 .sum().item() for h in states)
    return coarse / sum(h.numel() for h in states)


def _rows_err(have: list, want: list) -> float:
    """The widest error of ``have``'s entries over the root mean square of
    ``want``'s, over every pair."""
    worst = 0.0
    for h, w in zip(have, want):
        scale = w.pow(2).mean().sqrt().item()
        worst = max(worst, (h - w).abs().max().item() / scale)
    return worst
