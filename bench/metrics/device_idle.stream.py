"""Idle share of the device in the traced sub-window of the stream
cells (``harness/readers.py``)."""
from harness.readers import idle_percent


def read(run):
    if run.info.get("mode") != "stream":
        return None
    return idle_percent(run)
