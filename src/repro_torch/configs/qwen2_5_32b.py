"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].
40 heads: the JAX package shards it "spfsdp" (kept for parity; one card
shards nothing)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, qkv_bias=True,
    policy="spfsdp", supports_long=False)
