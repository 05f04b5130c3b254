"""nemotron-3-nano-30b-a3b [nemotron_h]: NVIDIA-Nemotron-3-Nano-30B-A3B as
published (nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16's config.json),
through ``models/nemotron_h.py``: 52 blocks of d_model=2688 in the
pattern ``MEMEM*EMEMEM*...EMEMEMEME``, 23 Mamba-2 (64 heads x 64, so
d_inner 4096; d_state 128, B and C in 8 groups, d_conv 4, chunk 128), 23
routed-expert (128 experts of 1856, top 6, sigmoid scores with a
selection-only bias, renormalised, x 2.5; relu^2, not gated; one shared
expert of 3712) and 6 GQA attention blocks (32 / 2 heads of 128, no
rotary embedding); vocab 131072, untied head, RMSNorm eps 1e-5.
Un-meshed."""
from repro_torch.models.common import NemotronHConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = NemotronHConfig(
    name="nemotron-3-nano-30b-a3b", family="nemotron_h",
    n_layers=len(PATTERN), pattern=PATTERN, d_model=2688, n_heads=32,
    n_kv_heads=2, head_dim=128, d_ff=1856, vocab=131072,
    rope_theta=10_000.0, n_experts=128, top_k=6, n_shared_experts=1,
    shared_expert_ff=3712, routed_scale=2.5,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_n_heads=64,
    ssm_conv_width=4, ssm_chunk=128, ssm_groups=8,
    policy="tp", supports_long=True)
