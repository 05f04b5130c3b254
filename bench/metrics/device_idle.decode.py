"""Idle share of the device in the traced sub-window of the decode
cells (``harness/readers.py``)."""
from harness.readers import idle_percent


def read(run):
    if "model" not in run.info:
        return None
    return idle_percent(run)
