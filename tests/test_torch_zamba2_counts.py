"""The benchmark's Zamba2 counts (``bench/harness/hybrid_counts.py``)
against the program's own shapes: the parameter count against
``registry.get("zamba2-7b")``'s parameters as ``meta`` tensors, the
state's bytes against ``cache_defs``' state and conv windows at the
cell's batch, and a decode step's FLOPs by hand at a tiny size."""
import json
import pathlib
import sys

import pytest

from repro_torch.models import registry, zamba2
from repro_torch.models.common import abstract_params, leaves
from repro_torch.models.transformer import cache_rows

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "bench"))

from harness import hybrid_counts  # noqa: E402

CONFIG = json.loads((ROOT / "bench" / "configs" / "zamba2-7b.json")
                    .read_text())


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def test_the_parameter_count_is_the_programs():
    api = registry.get("zamba2-7b")
    params = abstract_params(api.param_defs())
    got = sum(t.numel() for t in leaves(params))
    assert hybrid_counts.param_count(CONFIG) == got == api.count_params()
    assert got == 7_356_749_648


def test_the_state_bytes_are_the_caches_at_the_cells_batch():
    api = registry.get("zamba2-7b")
    b = json.loads((ROOT / "bench" / "traffic" / "decode.chat.json")
                   .read_text())["batch"]
    rows = cache_rows(api.cfg, b, 768)
    cache = abstract_params(api.cache_defs(b, rows))
    assert hybrid_counts.state_bytes(CONFIG, b) == _bytes(cache["mamba"])
    # 81 x 64 x 112 x 64 x 64 x 4 bytes of state, and the conv windows
    assert _bytes({"h": cache["mamba"]["h"]}) == 81 * 64 * 112 * 64 * 64 * 4
    assert cache["attn"]["k"].shape == (zamba2.n_apps(api.cfg), b, rows, 32,
                                        224)


@pytest.mark.parametrize("length", [1, 7])
def test_decode_step_flops_by_hand(length):
    m = {"hidden_size": 8, "mamba_expand": 2, "mamba_headdim": 4,
         "mamba_ngroups": 2, "mamba_d_state": 2, "mamba_d_conv": 4,
         "num_attention_heads": 2, "num_key_value_heads": 2,
         "intermediate_size": 6, "adapter_rank": 3, "num_mem_blocks": 2,
         "hybrid_layer_ids": [1, 2, 9], "num_hidden_layers": 3,
         "vocab_size": 10}
    # mixer: in_proj 8 x (32 + 8 + 4) = 352, out_proj 16 x 8 = 128
    mixer = 8 * 44 + 16 * 8
    # an application: q, k, v 16 x 16 each (2 heads of 2 x 8 / 2), o
    # 16 x 8, gate_up 8 x 12, adapter 8 x 3 + 3 x 12, down 6 x 8, linear
    # 8 x 8
    app = 3 * 16 * 16 + 128 + 96 + 24 + 36 + 48 + 64
    assert hybrid_counts.app_matmul_params(m) == app
    state = 3 * 6 * 4 * 4 * 2            # 3 layers, 4 heads of (4, 2)
    attn = 2 * 4 * 2 * length * 8        # two applications (9 is past 3)
    want = 2 * (3 * mixer + 2 * app + 8 * 10) + state + attn
    assert hybrid_counts.decode_step_flops(m, 5, length) == 5 * want
    assert hybrid_counts.hybrid_ids(m) == [1, 2]
    # the parameters by hand: each layer's norm and mixer (its products,
    # the conv's 4 x 24 weights and 24 biases, A, D and dt's bias by
    # head, the gated norm); the blocks; two applications' adapters and
    # linear maps; the embedding and the final norm
    per_layer = 8 + mixer + 4 * 24 + 24 + 3 * 4 + 16
    block = 16 + 16 * 48 + 16 * 8 + 8 + 8 * 12 + 6 * 8
    assert hybrid_counts.param_count(m) == \
        10 * 8 + 3 * per_layer + 2 * block + 2 * (24 + 36 + 64) + 8
