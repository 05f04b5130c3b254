"""Greedy decoding of a dense GQA decoder (Qwen2's layout) through the
program's serving step.

Set-up makes the weights on the device from the seed, in a few large
calls, in bfloat16, laid out as the program's ``models/transformer.py``
takes them; makes the cache of ``batch`` sessions that have each read
``context`` tokens (the rows of every layer drawn from the seed, written
into the layout ``cache_defs`` gives, with ``cache_rows``' padding, so no
prefill runs); and captures the decode step once as a CUDA graph
(``launch/steps.py::graph_decode_step`` over ``decode_fn``, which runs
the hand-written decode attention on every layer).  The model is the
configuration's, built as the program's ``ArchConfig``.

Traffic: generations of ``gen`` greedy steps from position ``context``;
each starts again at ``context`` with tokens drawn from the seed.  Steps
are dispatched ahead (at most ``dispatch_ahead`` in flight) and their
tokens stay on the device; a CUDA event is recorded after each step.
When the window closes the generation under way is finished, outside
the window.

The check, once the window has closed: ``check_sessions`` sessions drawn
from the seed, of the last generation, teacher-forced through the plain
reference (``reference/qwen2.py``) from the same cache rows (made again
from the seed), the same weights and the served tokens.  Compared: the
widest gap by which a served token's logit lies below the reference's
best (``logit_gap``), and the rows the steps wrote into the cache against
the reference's keys and values (``kv_rows_err``: the widest error over
the root mean square of the reference's rows, over every layer).
"""
from __future__ import annotations

import random
import time

from harness import inputs
from reference import qwen2 as ref


def arch_config(model: dict):
    """The configuration as the program's ``ArchConfig``."""
    from repro_torch.models.common import ArchConfig
    return ArchConfig(
        name=model["name"], family="dense",
        n_layers=model["num_hidden_layers"], d_model=model["hidden_size"],
        n_heads=model["num_attention_heads"],
        n_kv_heads=model["num_key_value_heads"],
        d_ff=model["intermediate_size"], vocab=model["vocab_size"],
        qkv_bias=model["qkv_bias"], rope_theta=model["rope_theta"])


def weight_leaves(model: dict) -> list:
    """(path, shape, kind) of every weight, in the order they are drawn."""
    d, f, v = model["hidden_size"], model["intermediate_size"], \
        model["vocab_size"]
    n, h = model["num_hidden_layers"], model["num_attention_heads"]
    kv = model["num_key_value_heads"] * (d // h)
    return [
        (("embed",), (v, d), "table"),
        (("layers", "ln_attn"), (n, d), "norm"),
        (("layers", "ln_mlp"), (n, d), "norm"),
        (("layers", "attn", "wq"), (n, d, d), "matrix"),
        (("layers", "attn", "wk"), (n, d, kv), "matrix"),
        (("layers", "attn", "wv"), (n, d, kv), "matrix"),
        (("layers", "attn", "wo"), (n, d, d), "matrix"),
        (("layers", "attn", "bq"), (n, d), "bias"),
        (("layers", "attn", "bk"), (n, kv), "bias"),
        (("layers", "attn", "bv"), (n, kv), "bias"),
        (("layers", "ffn", "w_gate"), (n, d, f), "matrix"),
        (("layers", "ffn", "w_up"), (n, d, f), "matrix"),
        (("layers", "ffn", "w_down"), (n, f, d), "matrix"),
        (("ln_f",), (d,), "norm"),
        (("lm_head",), (d, v), "matrix"),
    ]


def make_weights(torch, model: dict, device, seed: int) -> dict:
    """N(0, 1) draws, one flat bfloat16 tensor, then scaled: matrices by
    1/sqrt(fan_in), biases by 0.02, norms 1 + 0.02 N(0, 1), the
    embedding as drawn."""
    leaves = weight_leaves(model)
    shapes = [shape for _, shape, _ in leaves]
    total = sum(_numel(s) for s in shapes)
    views = inputs.carve(inputs.normal(torch, total, torch.bfloat16, device,
                                       seed, "weights"), shapes)
    tree = {}
    for (path, shape, kind), t in zip(leaves, views):
        if kind == "matrix":
            t.mul_(shape[-2] ** -0.5)
        elif kind == "bias":
            t.mul_(0.02)
        elif kind == "norm":
            t.mul_(0.02).add_(1.0)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def cache_rows_from_seed(torch, model: dict, batch: int, context: int,
                         device, seed: int, layer: int, kind: str):
    """Layer ``layer``'s first ``context`` rows of ``kind`` ("k" or "v")
    of every session, (batch, context, H_kv, D) bfloat16."""
    h, hk = model["num_attention_heads"], model["num_key_value_heads"]
    shape = (batch, context, hk, model["hidden_size"] // h)
    return inputs.normal(torch, _numel(shape), torch.bfloat16, device, seed,
                         "cache", kind, layer).view(shape)


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
        from repro_torch.models import transformer
        from repro_torch.models.registry import ModelApi
        arch = arch_config(m)
        api = ModelApi(cfg=arch, module=transformer)
        b, ctx, g = self.batch, self.context, self.gen
        t0 = time.perf_counter()
        self.weights = make_weights(torch, m, dev, self.seed)
        self._sync()
        self.spans["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = transformer.cache_rows(arch, b, ctx + g)
        n, hk = m["num_hidden_layers"], m["num_key_value_heads"]
        shape = (n, b, rows, hk, m["hidden_size"] // m["num_attention_heads"])
        self.cache = {kind: torch.zeros(shape, dtype=torch.bfloat16,
                                        device=dev) for kind in ("k", "v")}
        for layer in range(n):
            for kind in ("k", "v"):
                self.cache[kind][layer, :, :ctx].copy_(cache_rows_from_seed(
                    torch, m, b, ctx, dev, self.seed, layer, kind))
        self.info["cache_rows"] = rows
        gen_dev = inputs.generator(torch, dev, self.seed, "first tokens")
        self.firsts = torch.randint(m["vocab_size"],
                                    (self.traffic["first_tokens"], b, 1),
                                    generator=gen_dev, device=dev)
        self.served = torch.zeros((g, b), dtype=torch.int64, device=dev)
        self._sync()
        self.spans["cache_s"] = time.perf_counter() - t0
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
        self._sync()
        self.spans["warm_s"] = time.perf_counter() - t0
        self.n_gen, self.j = 0, 0
        self.tok = self.firsts[0]

    def _event(self):
        if self.device.type == "cuda":
            return self.torch.cuda.Event(enable_timing=True)
        return None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _one(self) -> int:
        """One step of the generation under way; returns the length its
        attention read."""
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
        return w

    def traced(self) -> dict:
        return self._drive(None, self.traffic["trace_steps"])

    def finish(self) -> None:
        """Finish the generation under way (outside the window), so that
        the last generation is whole."""
        while self.j or not self.n_gen:
            self._one()
        self._sync()
        self.last_gen = self.n_gen - 1

    def release(self) -> None:
        """Keep the last generation's tokens and the rows it wrote for the
        sampled sessions; free the graph and the cache."""
        torch, b = self.torch, self.batch
        rng = random.Random(inputs.derive(self.seed, "check sessions"))
        self.sessions = sorted(rng.sample(range(b), min(
            self.traffic["check_sessions"], b)))
        idx = torch.tensor(self.sessions, device=self.device)
        c, g = self.context, self.gen
        self.got_kv = {kind: self.cache[kind][:, idx, c:c + g].clone()
                       for kind in ("k", "v")}
        self.got_tokens = self.served[:, idx].t().clone()
        self.first = self.firsts[self.last_gen % len(self.firsts)][idx, 0]
        self.step = self.cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def check(self, control: bool = False) -> list:
        torch, m, dev = self.torch, self.model, self.device
        idx = torch.tensor(self.sessions, device=dev)

        def init_kv(layer):
            return tuple(cache_rows_from_seed(
                torch, m, self.batch, self.context, dev, self.seed, layer,
                kind)[idx] for kind in ("k", "v"))

        served = self.got_tokens
        tokens = torch.cat([self.first[:, None], served[:, :-1]], dim=1)
        logits, ks, vs = ref.forward(self.weights, m, init_kv, tokens,
                                     self.context)
        best = logits.max(dim=-1).values
        gap = (best - logits.gather(-1, served[..., None])[..., 0]).max()
        kv_err = _rows_err(self._program_rows(), ks + vs)
        limits = self.model["limits"]
        n = served.numel()
        out = [{"name": "logit_gap", "value": gap.item(),
                "limit": limits["logit_gap"], "compared": n},
               {"name": "kv_rows_err", "value": kv_err,
                "limit": limits["kv_rows_err"], "compared": n}]
        if control:
            c_logits, c_ks, c_vs = ref.forward(self.weights, m, init_kv,
                                               tokens, self.context,
                                               quant="fp8")
            pick = c_logits.argmax(dim=-1, keepdim=True)
            del c_logits
            c_gap = (best - logits.gather(-1, pick)[..., 0]).max()
            out += [{"name": "control.logit_gap", "value": c_gap.item(),
                     "limit": limits["logit_gap"], "compared": n},
                    {"name": "control.kv_rows_err",
                     "value": _rows_err(c_ks + c_vs, ks + vs),
                     "limit": limits["kv_rows_err"], "compared": n}]
        return out

    def _program_rows(self) -> list:
        return [self.got_kv[kind][layer].float() for kind in ("k", "v")
                for layer in range(self.model["num_hidden_layers"])]


def _rows_err(have: list, want: list) -> float:
    """The widest error of ``have``'s rows over the root mean square of
    ``want``'s, over every pair."""
    worst = 0.0
    for h, w in zip(have, want):
        scale = w.pow(2).mean().sqrt().item()
        worst = max(worst, (h - w).abs().max().item() / scale)
    return worst
