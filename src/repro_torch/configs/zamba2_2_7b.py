"""zamba2-2.7b [hybrid]: the JAX package's Zamba2-*style* layout at
Zamba2-2.7B's sizes (54L d_model=2560 Mamba2 backbone, 32H kv=32 of 80,
d_ff=10240, ssm_state=64; the sizes of arXiv:2411.15242), through
``models/hybrid.py``.  Hybrid -> runs long_500k.

Not the published layout, which ``models/zamba2.py`` runs (``zamba2-7b``).
Here ``w_in`` projects concat(x, x0) down to d and the attention runs at
d with heads of d / 32 scaled by D ** -0.5; one shared block, SwiGLU, no
adapters, a residual inside the block, the block after every 6th layer
and added to the residual stream; B and C in one group.  Published: the
attention reads the 2d concatenation after an RMSNorm over 2d (D = 2d /
h, scale (D / 2) ** -0.5), no residual inside the block, each hybrid
layer's own ``linear`` maps the block's output into that layer's
mixer's input, two blocks in turn, a rank-128 adapter on ``gate_up`` per
application, gelu(gate) * up, and B and C in ``mamba_ngroups`` groups
with the gated norm by group."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6,
    policy="tp", supports_long=True)
