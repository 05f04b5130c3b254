"""Tight-budget network variants: kernel-heavy backbones whose deepest
layers' kernel set Λ alone exceeds realistic on-chip budgets — the regime
where the network planner must swap kernel groups (S2) instead of the
paper's all-kernels-resident S1 assumption (Sec 9 future work).

The channel ramp is deliberately steep: early layers stay S1-feasible
under budgets that force the late layers into S2, so one network exercises
the S1→S2 crossover inside a single plan.  Spatial dims are kept small so
planning and functional simulation stay fast in tests and smoke runs.
"""
from repro_torch.core.conv_spec import ConvSpec

# Λ = 72 / 1152 / 4608 / 18432 elements: each stage 4x the previous.
TIGHT_L1 = ConvSpec(c_in=1, h_in=12, w_in=12, n_kernels=8, h_k=3, w_k=3)
TIGHT_L2 = ConvSpec(c_in=8, h_in=10, w_in=10, n_kernels=16, h_k=3, w_k=3)
TIGHT_L3 = ConvSpec(c_in=16, h_in=8, w_in=8, n_kernels=32, h_k=3, w_k=3)
TIGHT_L4 = ConvSpec(c_in=32, h_in=6, w_in=6, n_kernels=64, h_k=3, w_k=3)

# deep ramp: the full S1→S2 crossover in one plan
LAYERS = (TIGHT_L1, TIGHT_L2, TIGHT_L3, TIGHT_L4)

# shallow variant for quick smoke runs (one S1 layer, one S2 candidate)
LAYERS_SMALL = (TIGHT_L2, TIGHT_L3)


def budget_points(specs, fractions=(0.25, 0.5, 1.0, 2.0)) -> list[int]:
    """On-chip budgets as fractions of the largest layer's kernel set Λ —
    below 1.0 the largest layer cannot keep its kernels resident and the
    planner must fall back to S2 kernel-group swapping."""
    biggest = max(s.kernel_elements for s in specs)
    return sorted({max(1, int(biggest * f)) for f in fractions})
