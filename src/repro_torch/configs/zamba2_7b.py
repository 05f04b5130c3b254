"""zamba2-7b [zamba2]: Zamba2-7B as published (Zyphra/Zamba2-7B-Instruct's
config.json; arXiv:2411.15242), through ``models/zamba2.py``: 81 Mamba-2
layers of d_model=3584 (112 heads x 64, d_state 64, B and C in 2 groups,
d_conv 4, expand 2); two shared blocks used in turn on the 13 layers of
``hybrid_layer_ids``, each 32 heads (kv=32) of 224 over the 7168-wide
concatenation and a gelu-gated MLP of 14336, with a rank-128 adapter per
application; vocab 32000, tied embedding, RMSNorm eps 1e-5, rope_theta
1e4.  Un-meshed."""
from repro_torch.models.common import Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-7b", family="zamba2",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=224, rope_theta=10_000.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=256, ssm_groups=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2, adapter_rank=128,
    policy="tp", supports_long=True)
