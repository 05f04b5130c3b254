"""Host-side control plane: heartbeats, stragglers and elastic rescale
(:mod:`repro_torch.runtime.fault_tolerance`), which ``resil.controller``
drives on the simulated cycle clock."""
