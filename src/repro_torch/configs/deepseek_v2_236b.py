"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (MLA) d_ff=1536/expert
vocab=102400, MoE 2 shared + 160 routed top-6, kv_lora=512
[arXiv:2405.04434; hf]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    n_experts=160, top_k=6, n_shared_experts=2,
    mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    policy="tp", supports_long=False)
