"""A planned convolution network through the program's main path.

Set-up plans the configuration's layers with
``kernels.emit.plan_emitable_network`` under ``core.cost_model.H100_SXM``'s
shared-memory budget (host clock around it: ``plan_s``), emits each
layer with ``emit_layer_kernel`` and makes, from the seed and on the
device, the kernels of every layer and a pool of ``pool_images`` images,
each holding an input of every layer's shape.  A pass is the plan's
``EmittedConv.run`` calls in order, each on that image's own input of
its layer: the configuration's shapes do not chain without padding and
stride-2 subsampling, which the program does not do on the card.

Traffic (``mode``): ``stream`` dispatches passes back to back and
synchronises once, at the window's end (the launch queue applies
back-pressure); ``frame`` is one client's closed loop, each image's pass
ending in a synchronisation before the next starts.

The outputs of every ``check_every``-th pass (the phase drawn from the
seed) are kept and, once the window has closed, held against the plain
convolution of the same inputs (``reference/conv2d.py``): the widest
error of any output value over the root mean square of its layer's
reference outputs, over every layer.
"""
from __future__ import annotations

import random
import time

from harness import inputs
from reference import conv2d as ref

class Cell:
    def __init__(self, torch, device, cfg: dict, traffic: dict, seed: int):
        self.torch, self.device = torch, device
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dtype_name = cfg["dtype"]
        self.dtype = getattr(torch, self.dtype_name)
        self.mode = traffic["mode"]
        if self.mode not in ("stream", "frame"):
            raise ValueError(f"unknown conv traffic mode {self.mode!r}")
        self.layers = cfg["layers"]
        self.info = {"layers": self.layers, "dtype": self.dtype_name,
                     "mode": self.mode}
        self.spans = {}

    # ------------------------------------------------------------ set-up
    def build(self) -> None:
        torch, dev = self.torch, self.device
        from repro_torch.core.conv_spec import ConvSpec
        from repro_torch.core.cost_model import H100_SXM
        from repro_torch.kernels import conv2d_offload
        from repro_torch.kernels.emit import (emit_layer_kernel,
                                              plan_emitable_network)
        specs = [ConvSpec(**layer) for layer in self.layers]
        elem = torch.empty((), dtype=self.dtype).element_size()
        t0 = time.perf_counter()
        plan = plan_emitable_network(
            specs, H100_SXM.as_hardware_model(dtype_bytes=elem),
            name=self.cfg["name"])
        self.emitted = [emit_layer_kernel(lp) for lp in plan.layers]
        self.spans["plan_s"] = time.perf_counter() - t0
        self.info["charged_per_pass"] = sum(
            lp.strategy.pixels_loaded() * lp.spec.c_in
            + lp.spec.kernel_elements for lp in plan.layers)
        self.counter = conv2d_offload.fetched_counter(dev) \
            if dev.type == "cuda" else None

        t0 = time.perf_counter()
        k_shapes = [(l["n_kernels"], l["c_in"], l["h_k"], l["w_k"])
                    for l in self.layers]
        wsize = sum(a * b * c * d for a, b, c, d in k_shapes)
        self.weights = inputs.carve(inputs.normal(
            torch, wsize, self.dtype, dev, self.seed, "kernels"), k_shapes)
        for w in self.weights:
            w.mul_(w[0].numel() ** -0.5)
        n = self.traffic["pool_images"]
        x_shapes = [(n, l["c_in"], l["h_in"], l["w_in"]) for l in self.layers]
        xsize = sum(a * b * c * d for a, b, c, d in x_shapes)
        self.pool = inputs.carve(inputs.normal(
            torch, xsize, self.dtype, dev, self.seed, "images"), x_shapes)
        rng = random.Random(inputs.derive(self.seed, "order"))
        self.order = list(range(n))
        rng.shuffle(self.order)
        self.every = self.traffic["check_every"]
        self.phase = rng.randrange(self.every)
        self.kept = []
        self.passes = 0
        self._sync()
        self.spans["inputs_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(self.traffic["warm_passes"]):
            self._pass(0)
        self._sync()
        # the kept outputs of a window take blocks from the allocator's
        # cache, reserved here, not from the device inside the window
        reserve = [[torch.empty((l["n_kernels"],) + tuple(
            d for d in _out_hw(l)), dtype=self.dtype, device=dev)
            for l in self.layers] for _ in range(self.traffic["reserve"])]
        del reserve
        self.spans["warm_s"] = time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _pass(self, img: int) -> list:
        return [em.run(self.pool[i][img], self.weights[i])
                for i, em in enumerate(self.emitted)]

    # ------------------------------------------------------------ window
    def _drive(self, seconds: float | None, count: int | None) -> dict:
        """Passes until ``seconds`` have gone by on the host's clock, or
        ``count`` passes; the host time inside the calls and, for frame
        traffic, each image's latency."""
        frame = self.mode == "frame"
        order, n = self.order, len(self.order)
        emitted, pool, weights = self.emitted, self.pool, self.weights
        calls_s, lat, done = 0.0, [], 0
        clock = time.perf_counter
        t0 = clock()
        while True:
            if count is None:
                if clock() - t0 >= seconds:
                    break
            elif done >= count:
                break
            p = self.passes
            img = order[p % n]
            start = clock()
            outs = []
            for i, em in enumerate(emitted):
                a = clock()
                outs.append(em.run(pool[i][img], weights[i]))
                calls_s += clock() - a
            if frame:
                self._sync()
                lat.append(clock() - start)
            if p % self.every == self.phase:
                self.kept.append((img, outs))
            self.passes += 1
            done += 1
        self._sync()
        return {"elapsed_s": clock() - t0, "passes": done, "calls_s": calls_s,
                "calls": done * len(emitted), "latency_s": lat}

    def window(self, seconds: float) -> dict:
        if self.counter is not None:
            self.counter.zero_()
        w = self._drive(seconds, None)
        if self.counter is not None:
            w["fetched"] = int(self.counter.item())
        w["images_per_s"] = w["passes"] / w["elapsed_s"]
        if w["latency_s"]:
            from harness.yardstick import p95
            w["image_ms_p95"] = p95(w["latency_s"]) * 1e3
        self.attempted = w["passes"]
        return w

    def traced(self) -> dict:
        return self._drive(None, self.traffic["trace_passes"])

    def finish(self) -> None:
        """Every pass has ended at its window's synchronisation."""

    def release(self) -> None:
        self.emitted = None

    # ------------------------------------------------------------ check
    def check(self, control: bool = False) -> list:
        """The widest error over the kept passes' outputs, against the
        plain convolution; with ``control``, the TF32 control's too."""
        torch = self.torch
        imgs = [img for img, _ in self.kept]
        worst, worst_ctrl = 0.0, 0.0
        for i, l in enumerate(self.layers):
            s_h, s_w = l.get("s_h", 1), l.get("s_w", 1)
            for lo in range(0, len(imgs), 256):
                idx = torch.tensor(imgs[lo:lo + 256], device=self.device)
                x = self.pool[i][idx]
                want = ref.conv2d(x, self.weights[i], s_h, s_w)
                got = torch.stack([outs[i] for _, outs in
                                   self.kept[lo:lo + 256]]).float()
                scale = want.pow(2).mean().sqrt().item()
                worst = max(worst, (got - want).abs().max().item() / scale)
                if control:
                    ctrl = ref.conv2d_tf32(x, self.weights[i], s_h, s_w)
                    worst_ctrl = max(worst_ctrl, (ctrl - want).abs().max()
                                     .item() / scale)
        if not imgs:
            worst = worst_ctrl = float("inf")
        limit = self.cfg["limits"]["conv_out_err"]
        out = [{"name": "conv_out_err", "value": worst, "limit": limit,
                "compared": len(imgs)}]
        if control:
            out.append({"name": "control.conv_out_err", "value": worst_ctrl,
                        "limit": limit, "compared": len(imgs)})
        return out


def _out_hw(layer: dict) -> tuple[int, int]:
    return ((layer["h_in"] - layer["h_k"]) // layer.get("s_h", 1) + 1,
            (layer["w_in"] - layer["w_k"]) // layer.get("s_w", 1) + 1)
