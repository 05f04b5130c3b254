"""Host microseconds a conv call takes to enqueue, in the stream cell's
window (``harness/readers.py``).  Moves the stream cell's end-to-end
metric."""
from harness.readers import enqueue_us


def read(run):
    return enqueue_us(run, "stream")
