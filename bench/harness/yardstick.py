"""The yardstick, kept with the benchmark so that no change to the program
moves it: the card's data-sheet peaks, the operations and bytes of the
kernels the cells time, counted from shapes, and the model's FLOPs.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.  Bytes
count each input read once and each output written once, whatever a
kernel reads again.  The model FLOPs follow the arithmetic of
``repro_torch.launch.model_flops`` (2 x the matmul parameters a token
touches, embedding gather excluded, LM head included; attention's
QK^T and PV over the cache), copied here, not imported.
"""
from __future__ import annotations

import statistics

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


# ------------------------------ K1 ------------------------------------ #

def conv_out_hw(layer: dict) -> tuple[int, int]:
    s_h, s_w = layer.get("s_h", 1), layer.get("s_w", 1)
    return ((layer["h_in"] - layer["h_k"]) // s_h + 1,
            (layer["w_in"] - layer["w_k"]) // s_w + 1)


def conv_macs(layer: dict) -> int:
    h_out, w_out = conv_out_hw(layer)
    return (layer["c_in"] * layer["h_k"] * layer["w_k"]
            * layer["n_kernels"] * h_out * w_out)


def conv_flops(layer: dict) -> int:
    return 2 * conv_macs(layer)


def conv_bytes(layer: dict, dtype: str) -> int:
    """Input, kernels and output, once each."""
    h_out, w_out = conv_out_hw(layer)
    elems = (layer["c_in"] * layer["h_in"] * layer["w_in"]
             + layer["n_kernels"] * layer["c_in"] * layer["h_k"]
             * layer["w_k"]
             + layer["n_kernels"] * h_out * w_out)
    return elems * ELEM_BYTES[dtype]


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def conv_pass_least_seconds(layers: list, dtype: str) -> float:
    """A pass's least time: each layer's launch bound on its own."""
    return sum(least_seconds(conv_flops(l), conv_bytes(l, dtype), dtype)
               for l in layers)


# ------------------------------ K5 ------------------------------------ #

def k5_bytes(batch: int, n_heads: int, n_kv_heads: int, head_dim: int,
             length: int, elem: int = 2) -> int:
    """One decode-attention call: K and V rows up to ``length`` of every
    (sequence, KV head), q read and the output written."""
    kv = 2 * batch * n_kv_heads * length * head_dim * elem
    return kv + 2 * batch * n_heads * head_dim * elem


def k5_flops(batch: int, n_heads: int, head_dim: int, length: int) -> int:
    """QK^T and PV over ``length`` rows for every query head."""
    return 4 * batch * n_heads * length * head_dim


# --------------------------- model FLOPs ------------------------------ #

def dense_matmul_params_per_token(m: dict) -> int:
    """Matmul parameters one token touches in a dense GQA decoder with a
    SwiGLU feed-forward, LM head included, embedding gather excluded."""
    d, h, hk = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    dh = d // h
    attn = d * h * dh + 2 * d * hk * dh + h * dh * d
    ffn = 3 * d * m["intermediate_size"]
    return m["num_hidden_layers"] * (attn + ffn) + d * m["vocab_size"]


def decode_step_flops(m: dict, batch: int, length: int) -> int:
    """One decode step of ``batch`` sequences whose attention reads
    ``length`` rows each: 2 x matmul parameters x batch, plus QK^T and PV
    in every layer."""
    h = m["num_attention_heads"]
    dh = m["hidden_size"] // h
    return batch * (2 * dense_matmul_params_per_token(m)
                    + m["num_hidden_layers"] * 4 * length * h * dh)


# ------------------------------ stats --------------------------------- #

def p95(values: list) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def spread(values: list) -> float:
    """Interquartile distance over the median (the bound's rule)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
