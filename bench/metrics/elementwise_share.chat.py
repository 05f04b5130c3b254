"""The share of the traced decode steps' device time, in per cent, in
kernels that are neither K5 (its split and combine kernels) nor a
matrix product of cuBLAS or cuBLASLt (names holding ``gemm``, ``gemv``,
``nvjet`` or ``xmma``, and cuBLAS's split-K reduction): the recurrence's
element-wise work, the conv window's update, the gated norms, gelu, the
casts and copies.  Read only where the capture counted, a replay, one
recurrent update a layer and one application a hybrid layer
(``launches_per_replay``).  Moves ``decode_tokens_per_s``."""
from harness.readers import K5_KERNELS

PRODUCTS = ("gemm", "gemv", "nvjet", "xmma", "splitKreduce")


def read(run):
    m, per = run.info.get("model", {}), run.info.get("launches_per_replay")
    if not run.trace or not per or "hybrid_layer_ids" not in m:
        return None
    apps = sum(v for k, v in per.items() if k.startswith("zamba2_block"))
    hybrid = [i for i in m["hybrid_layer_ids"]
              if i < m["num_hidden_layers"]]
    if per.get("ssm_update") != m["num_hidden_layers"] or \
            apps != len(hybrid):
        return None
    total = run.trace.device_seconds()
    other = sum(b - a for name, a, b, _ in run.trace.device
                if not any(k in name for k in K5_KERNELS)
                and not any(p in name for p in PRODUCTS)) * 1e-6
    return other / total * 100.0 if total else None
