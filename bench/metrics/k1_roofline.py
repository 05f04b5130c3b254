"""K1's share of its roofline, in per cent: the least time of the traced
passes' launches (each launch: the larger of its operations over the
peak rate and its input, kernels and output bytes, once each, over 3.35
TB/s) over K1's device time in the trace.  K1's time is the mean of the
``conv2d_offload_planned_kernel`` events seen times the launches made
(layers x traced passes), so an event Kineto dropped is not read as
time saved.  Moves ``images_per_s``."""
from harness import yardstick


def read(run):
    if not run.trace:
        return None
    layers, passes = run.info["layers"], run.traced["passes"]
    k1 = run.trace.kernel_seconds("conv2d_offload_planned_kernel",
                                  launches=len(layers) * passes)
    if not k1:
        return None
    least = yardstick.conv_pass_least_seconds(layers, run.info["dtype"])
    return least * passes / k1 * 100.0
