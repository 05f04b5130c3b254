"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early fusion, VQ image tokens (frontend stub: inputs are
token ids over the unified vocab), QK-norm [arXiv:2405.09818; unverified]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, qk_norm=True,
    policy="tp", supports_long=False)
