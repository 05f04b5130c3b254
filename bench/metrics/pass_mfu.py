"""The whole pass's share of the card's peak, in per cent: 2 x the MACs
of every layer of a pass, times the passes of the window, over the
window's seconds (host clock, to its final synchronisation), over the
data sheet's rate of the configuration's precision (67 TFLOP/s f32).
Moves ``images_per_s``."""
from harness import yardstick


def read(run):
    passes, secs = run.window.get("passes"), run.window.get("elapsed_s")
    if not passes or not secs:
        return None
    flops = sum(yardstick.conv_flops(l) for l in run.info["layers"])
    peak = yardstick.PEAK_FLOPS[run.info["dtype"]]
    return flops * passes / secs / peak * 100.0
