"""zamba2-2.7b [hybrid]: 54L d_model=2560 Mamba2 backbone + shared attn
block (32H kv=32, d_ff=10240) every 6 layers, ssm_state=64
[arXiv:2411.15242; hf].  Hybrid -> runs long_500k."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6,
    policy="tp", supports_long=True)
