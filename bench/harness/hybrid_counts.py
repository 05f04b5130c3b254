"""Zamba2's counts, kept with the benchmark so that no change to the
program moves them: its parameters, the FLOPs of a decode step and the
bytes of its recurrent state, from the configuration's keys (those of
the published config.json).

A decode step's FLOPs are 2 x the multiply-adds of every product a token
makes: each layer's mixer projections (``in_proj`` to z, x, B, C and dt,
``out_proj``), each application's q, k and v over the 2d-wide
concatenation, ``o_proj``, ``gate_up`` and its adapter, ``down`` and the
application's ``linear``, and the tied head; its attention's QK^T and PV
at the step's length (``yardstick.k5_flops``); and the state update, 6
operations an entry of every head's (P, N) state (decay, dt x B^T, the
sum, C's read-out as a multiply-add).  The causal conv and the
element-wise work are left out.
"""
from __future__ import annotations

from harness import yardstick


def sizes(m: dict) -> dict:
    """The widths the counts use; the attention's head is 2d / heads
    wide, as the published configuration derives it."""
    d = m["hidden_size"]
    di = m["mamba_expand"] * d
    heads = di // m["mamba_headdim"]
    bc = m["mamba_ngroups"] * m["mamba_d_state"]
    return {"d": d, "di": di, "heads": heads, "p": m["mamba_headdim"],
            "n": m["mamba_d_state"], "bc": bc, "conv": di + 2 * bc,
            "proj": 2 * di + 2 * bc + heads, "width": m["mamba_d_conv"],
            "h": m["num_attention_heads"], "hk": m["num_key_value_heads"],
            "dh": 2 * d // m["num_attention_heads"],
            "ff": m["intermediate_size"], "r": m["adapter_rank"],
            "apps": len(hybrid_ids(m)), "layers": m["num_hidden_layers"],
            "blocks": m["num_mem_blocks"], "vocab": m["vocab_size"]}


def hybrid_ids(m: dict) -> list:
    """The hybrid layers that the model's depth holds."""
    return [i for i in m["hybrid_layer_ids"] if i < m["num_hidden_layers"]]


def param_count(m: dict) -> int:
    """Every parameter: the embedding (tied to the head), each layer's
    norm and mixer, the shared blocks, each application's adapter and
    ``linear``, the final norm."""
    s = sizes(m)
    d, di = s["d"], s["di"]
    mixer = (d * s["proj"] + s["width"] * s["conv"] + s["conv"]
             + 3 * s["heads"] + di + di * d)
    block = (2 * d + 2 * d * (s["h"] + 2 * s["hk"]) * s["dh"]
             + s["h"] * s["dh"] * d + d + d * 2 * s["ff"] + s["ff"] * d)
    app = d * s["r"] + s["r"] * 2 * s["ff"] + d * d
    return (s["vocab"] * d + s["layers"] * (d + mixer)
            + s["blocks"] * block + s["apps"] * app + d)


def app_matmul_params(m: dict) -> int:
    """The multiply-adds a token makes in one application's products."""
    s = sizes(m)
    d = s["d"]
    return (2 * d * (s["h"] + 2 * s["hk"]) * s["dh"] + s["h"] * s["dh"] * d
            + d * 2 * s["ff"] + d * s["r"] + s["r"] * 2 * s["ff"]
            + s["ff"] * d + d * d)


def decode_step_flops(m: dict, batch: int, length: int) -> int:
    """One decode step of ``batch`` sequences whose attention reads
    ``length`` rows each."""
    s = sizes(m)
    d = s["d"]
    mixer = d * s["proj"] + s["di"] * d
    per_token = 2 * (s["layers"] * mixer + s["apps"] * app_matmul_params(m)
                     + d * s["vocab"])
    state = s["layers"] * 6 * s["heads"] * s["p"] * s["n"]
    attn = s["apps"] * yardstick.k5_flops(1, s["h"], s["dh"], length)
    return batch * (per_token + state + attn)


def state_bytes(m: dict, batch: int) -> int:
    """The recurrent state of ``batch`` sequences: every layer's (H, P, N)
    state in float32 and its conv window of ``d_conv - 1`` inputs in
    bfloat16."""
    s = sizes(m)
    h = s["heads"] * s["p"] * s["n"] * 4
    conv = (s["width"] - 1) * s["conv"] * 2
    return s["layers"] * batch * (h + conv)
