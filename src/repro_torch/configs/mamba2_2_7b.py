"""mamba2-2.7b [ssm]: 64L d_model=2560 attn-free, ssm_state=128, SSD
[arXiv:2405.21060; unverified].  Sub-quadratic -> runs long_500k."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=None,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    policy="tp", supports_long=True)
