"""K5's share of the device time of the traced decode steps, in per cent:
its split and combine kernels' seconds (``harness/readers.py``) over the sum of every
device event's seconds in the trace.  Moves ``decode_tokens_per_s``."""
from harness.readers import k5_seconds


def read(run):
    k5 = k5_seconds(run)
    if not k5:
        return None
    return k5 / run.trace.device_seconds() * 100.0
