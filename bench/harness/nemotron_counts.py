"""Nemotron-H's counts (routed experts beside Mamba-2 and attention
blocks), kept with the benchmark so that no change to the program moves
them: its parameters, the FLOPs of a decode step, the bytes of its
recurrent state and the least bytes of its routed experts, from the
configuration's keys (those of the published config.json).

A decode step's FLOPs are 2 x the multiply-adds of every product a token
makes: each Mamba block's ``in_proj`` (to z, x, B, C and dt) and
``out_proj``; each expert block's router, the ``num_experts_per_tok``
routed experts' ``up`` and ``down`` and the shared expert's; each
attention block's q, k, v and o; the untied head; plus each attention
block's QK^T and PV at the step's length (``yardstick.k5_flops``) and the
state update, 6 operations an entry of every head's (P, N) state (decay,
dt x B^T, the sum, C's read-out as a multiply-add).  The causal conv, the
relu^2, the norms and the element-wise work are left out.
"""
from __future__ import annotations

from harness import yardstick


def sizes(m: dict) -> dict:
    """The widths the counts use; d_inner is the Mamba-2 heads times
    their width, as the published configuration derives it."""
    heads, p = m["mamba_num_heads"], m["mamba_head_dim"]
    di = heads * p
    bc = m["n_groups"] * m["ssm_state_size"]
    pattern = m["hybrid_override_pattern"]
    return {"d": m["hidden_size"], "di": di, "heads": heads, "p": p,
            "n": m["ssm_state_size"], "bc": bc, "conv": di + 2 * bc,
            "proj": 2 * di + 2 * bc + heads, "width": m["conv_kernel"],
            "h": m["num_attention_heads"], "hk": m["num_key_value_heads"],
            "dh": m["head_dim"], "experts": m["n_routed_experts"],
            "top_k": m["num_experts_per_tok"],
            "ff": m["moe_intermediate_size"],
            "shared_ff": m["moe_shared_expert_intermediate_size"]
            * m["n_shared_experts"],
            "mamba": pattern.count("M"), "moe": pattern.count("E"),
            "attn": pattern.count("*"), "vocab": m["vocab_size"]}


def _block_params(s: dict) -> dict:
    """Each kind of block's parameters, its norm included."""
    d, di = s["d"], s["di"]
    mamba = (d * s["proj"] + s["width"] * s["conv"] + s["conv"]
             + 3 * s["heads"] + di + di * d)
    expert = 2 * d * s["ff"]
    moe = d * s["experts"] + s["experts"] + s["experts"] * expert \
        + 2 * d * s["shared_ff"]
    attn = d * (s["h"] + 2 * s["hk"]) * s["dh"] + s["h"] * s["dh"] * d
    return {"M": d + mamba, "E": d + moe, "*": d + attn, "expert": expert}


def param_count(m: dict) -> int:
    """Every parameter: the embedding, each block's norm and mixer, the
    final norm and the untied head."""
    s = sizes(m)
    b = _block_params(s)
    return (2 * s["vocab"] * s["d"] + s["d"] + s["mamba"] * b["M"]
            + s["moe"] * b["E"] + s["attn"] * b["*"])


def active_param_count(m: dict) -> int:
    """The parameters a token's step reads: all but the embedding (a
    lookup) and the routed experts it did not choose."""
    s = sizes(m)
    unchosen = s["moe"] * (s["experts"] - s["top_k"]) \
        * _block_params(s)["expert"]
    return param_count(m) - s["vocab"] * s["d"] - unchosen


def token_matmul_params(m: dict) -> int:
    """The multiply-adds a token makes in the step's products."""
    s = sizes(m)
    d = s["d"]
    mamba = d * s["proj"] + s["di"] * d
    moe = d * s["experts"] + s["top_k"] * 2 * d * s["ff"] \
        + 2 * d * s["shared_ff"]
    attn = d * (s["h"] + 2 * s["hk"]) * s["dh"] + s["h"] * s["dh"] * d
    return (s["mamba"] * mamba + s["moe"] * moe + s["attn"] * attn
            + d * s["vocab"])


def decode_step_flops(m: dict, batch: int, length: int) -> int:
    """One decode step of ``batch`` sequences whose attention reads
    ``length`` rows each."""
    s = sizes(m)
    state = s["mamba"] * 6 * s["heads"] * s["p"] * s["n"]
    attn = s["attn"] * yardstick.k5_flops(1, s["h"], s["dh"], length)
    return batch * (2 * token_matmul_params(m) + state + attn)


def state_bytes(m: dict, batch: int) -> int:
    """The recurrent state of ``batch`` sequences: every Mamba block's
    (H, P, N) state in float32 and its conv window of ``conv_kernel - 1``
    inputs in bfloat16."""
    s = sizes(m)
    h = s["heads"] * s["p"] * s["n"] * 4
    conv = (s["width"] - 1) * s["conv"] * 2
    return s["mamba"] * batch * (h + conv)


def expert_least(m: dict, experts: int, pairs: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one expert layer's routed experts at least: the
    ``up`` and ``down`` matrices of each of the ``experts`` chosen read
    once in bfloat16, and each of the ``pairs`` chosen (token, expert)
    rows read in and written out once in bfloat16; 2 x the pairs'
    multiply-adds."""
    s = sizes(m)
    d, f = s["d"], s["ff"]
    return pairs * 2 * 2 * d * f, experts * 2 * d * f * 2 + 2 * pairs * d * 2
