"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias [arXiv:2407.10671; hf].  28 heads: the JAX
package shards it "spfsdp" (kept for parity; one card shards nothing)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, qkv_bias=True,
    policy="spfsdp", supports_long=False)
