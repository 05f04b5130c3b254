"""The share of the device's idle time, in per cent, in the stream
cell's traced sub-window, during which the host was in a conv call's
fixed work: each ``conv.run`` span less its ``conv.launch``, put on the
trace's clock by the offset at which every ``conv.launch`` holds K1's
``cudaLaunchKernelExC`` (``harness/spans.py``).  Idle time: the gaps
between the trace's device events."""
from harness import spans


def read(run):
    if run.info.get("mode") != "stream":
        return None
    snap = spans.recorded()
    fit = spans.fit_clock(snap, run.trace, *spans.CONV_CALL)
    if fit is None:
        return None
    return spans.idle_share_in(run.trace,
                               spans.conv_prep_intervals(snap, fit))
