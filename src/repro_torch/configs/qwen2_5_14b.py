"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].  40 heads: the
JAX package shards it "spfsdp" (kept for parity; one card shards nothing)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, qkv_bias=True,
    policy="spfsdp", supports_long=False)
