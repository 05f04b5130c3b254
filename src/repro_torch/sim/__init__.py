"""Python-based simulator of the offloading process (paper Sec 6).

Mirrors the paper's class structure: the ``System`` orchestrator drives a
``Strategy`` step by step against an ``Accelerator`` (on-chip memory +
processing element) and a ``Dram``; the ``ConvLayer`` carries the problem
data.  The simulation is *functional*: real values are convolved, and the
final DRAM output is checked against a reference convolution.

It is a host-side model and launches no kernel: its values stay numpy
arrays, as in the JAX package, so that the two packages' reports can be
held equal to the bit.  ``functional.reference_conv_torch`` is the
independent oracle (``torch.nn.functional.conv2d`` on the CPU).
"""
from repro_torch.sim.accelerator import Accelerator, OnChipMemory
from repro_torch.sim.dram import Dram
from repro_torch.sim.layer import ConvLayer
from repro_torch.sim.multichip import MultiChipSimReport, simulate_multichip
from repro_torch.sim.network import NetworkSimReport, simulate_network
from repro_torch.sim.system import SimReport, System
from repro_torch.sim.functional import reference_conv

__all__ = ["Accelerator", "OnChipMemory", "Dram", "ConvLayer",
           "System", "SimReport", "reference_conv",
           "NetworkSimReport", "simulate_network",
           "MultiChipSimReport", "simulate_multichip"]
