"""Idle share of the device in the traced sub-window of the frame
cells (``harness/readers.py``)."""
from harness.readers import idle_percent


def read(run):
    if run.info.get("mode") != "frame":
        return None
    return idle_percent(run)
