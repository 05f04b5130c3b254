"""Static analysis for offload plans.

``repro_torch.analysis.verifier`` proves a ``NetworkPlan`` /
``MultiChipPlan`` legal *symbolically* — per-step residency ledger,
coverage, shard/ICI geometry, and analytic duration floors — without
running a simulator.  The planners call it as a postcondition when
``REPRO_VERIFY_PLANS`` is set.
"""
from repro_torch.analysis.diagnostics import (Diagnostic,
                                              PlanVerificationError,
                                              Severity, VerificationReport)
from repro_torch.analysis.verifier import (verify_multichip_plan,
                                           verify_network_plan, verify_steps)

__all__ = [
    "Diagnostic",
    "PlanVerificationError",
    "Severity",
    "VerificationReport",
    "verify_multichip_plan",
    "verify_network_plan",
    "verify_steps",
]
